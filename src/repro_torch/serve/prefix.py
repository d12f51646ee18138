"""PrefixCache: cross-request KV prefix sharing — radix-matched,
refcounted, copy-on-write paged (counterpart of the JAX package's
``serve/prefix.py``).

One level above the paper's sectored rows the same locality exists
across *requests*: system prompts repeat, so the KV pages they produce
are worth computing once and sharing. The session wires this cache into
admission, the page pool, the within-wave demand OR-merge and the energy
meter.

Three pieces:

* **Radix tree** — a path-compressed trie over token ids. ``match``
  returns the longest common prefix between a prompt and any cached
  sequence, plus a *donor* entry agreeing on that prefix. Matching is
  O(match length), independent of how many prefixes are cached.
* **Refcounted entries** — a :class:`CacheEntry` pins the post-prefill
  decode state for one token sequence. The port's decode steps append
  K/V in place, so the entry's state is never handed to a slot as it is:
  the backend's ``state_prefix`` clones it when it seeds a warm
  admission. ``acquire`` returns a :class:`PrefixLease` and bumps the
  refcount; ``release`` is idempotent. An entry is evictable only at
  refcount 0, in LRU order.
* **Copy-on-write accounting** — a reader whose match ends inside a
  page shares only the *complete* pages; the partial page is its own
  private copy (``cow_copies``). The sharing is the *accounting model*
  the page pool and energy meter consume, a deterministic host-side
  accountant.

Determinism contract (the cold-vs-warm oracle): on the exact decode path
a warm admission is invisible in token streams and logprobs. A cached
state's KV rows for positions ``< m`` depend only on the ``m`` matched
tokens, the exact attend masks every row past the cache length to exact
zero, and ``suffix_prefill`` replays the *same* exact step a cold
prefill runs, so seeding from a donor cut to ``m`` tokens and prefilling
only the suffix reproduces the cold state wherever it is read.

One change against the reference: ``insert`` makes room (evicting LRU
entries) *before* it walks the tree to the insertion point. The
reference walks first, so an eviction can prune the very node the walk
returned and the new entry lands under a node no longer in the tree
(then ``match`` misses it and ``shed`` raises ``KeyError``). On every
sequence where the reference's tree stays consistent both orders give
the same tree.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterator

import numpy as np

from repro_torch.serve.pool import DEFAULT_PAGE_SIZE


def _tokens_key(tokens) -> tuple:
    """Canonical hashable key for a token sequence."""
    return tuple(int(t) for t in np.asarray(tokens).reshape(-1))


@dataclasses.dataclass
class CacheEntry:
    """One cached prefix: a post-prefill state pinned under its token
    sequence. ``state`` is the donor request's prefill output, read only
    through the backend's ``state_prefix`` (which copies it); ``pages``
    is the entry's charge against the pool budget, counted ONCE no matter
    how many readers share it."""

    entry_id: int
    tokens: tuple
    state: Any
    pages: int
    refcount: int = 0
    tick: int = 0  # LRU recency stamp

    def __len__(self) -> int:
        return len(self.tokens)


@dataclasses.dataclass
class PrefixLease:
    """One reader's hold on a shared entry.

    ``matched_tokens`` is the full radix match ``m`` (every matched
    token's KV row is reused — the suffix re-prefill starts at ``m``);
    ``shared_tokens`` is the page-aligned part ``(m // page_size) *
    page_size`` — only *complete* pages count as shared in the pool and
    the meter, the partial page is the reader's copy-on-write private
    copy. ``release`` via the owning cache is idempotent.
    """

    entry: CacheEntry
    matched_tokens: int
    shared_tokens: int
    page_size: int = DEFAULT_PAGE_SIZE
    released: bool = False

    @property
    def shared_pages(self) -> int:
        return self.shared_tokens // self.page_size


class _Node:
    """Path-compressed trie node; ``edge`` is the compressed label from
    the parent, ``entry`` the cache entry terminating exactly here."""

    __slots__ = ("edge", "children", "entry")

    def __init__(self, edge: tuple = ()):
        self.edge = edge
        self.children: dict[int, _Node] = {}
        self.entry: CacheEntry | None = None


def _common_len(a: tuple, b: tuple, b_off: int) -> int:
    n = min(len(a), len(b) - b_off)
    for i in range(n):
        if a[i] != b[b_off + i]:
            return i
    return n


class PrefixCache:
    """Radix-matched, refcounted, LRU-evicted KV prefix cache.

    ``capacity_pages`` bounds the summed page charge of resident entries
    (``page_size`` tokens per page — match the session pool's page size
    so both account in the same currency; the session validates this).
    ``min_match_tokens`` is the hit threshold: shorter matches are
    treated as misses so the suffix-prefill specialization isn't paid
    for near-zero reuse.
    """

    def __init__(self, capacity_pages: int = 64, *,
                 page_size: int = DEFAULT_PAGE_SIZE,
                 min_match_tokens: int = 1):
        if capacity_pages < 1:
            raise ValueError(
                f"capacity_pages must be >= 1, got {capacity_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if min_match_tokens < 1:
            raise ValueError(
                f"min_match_tokens must be >= 1, got {min_match_tokens}")
        self.capacity_pages = capacity_pages
        self.page_size = page_size
        self.min_match_tokens = min_match_tokens
        self._root = _Node()
        self._entries: dict[int, CacheEntry] = {}
        self._next_id = 0
        self._tick = 0
        self.stats = self._zero_stats()

    @staticmethod
    def _zero_stats() -> dict[str, int]:
        return dict(hits=0, misses=0, hit_tokens=0, insertions=0,
                    evictions=0, cow_copies=0, releases=0, shed_pages=0)

    def reset_stats(self) -> None:
        self.stats = self._zero_stats()

    # -- introspection -----------------------------------------------------

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def held_pages(self) -> int:
        """Pool pages all resident entries charge (each counted once)."""
        return sum(e.pages for e in self._entries.values())

    @property
    def hit_rate(self) -> float:
        looked = self.stats["hits"] + self.stats["misses"]
        return self.stats["hits"] / looked if looked else 0.0

    def entries(self) -> Iterator[CacheEntry]:
        return iter(self._entries.values())

    def pages_for(self, n_tokens: int) -> int:
        return max(-(-int(n_tokens) // self.page_size), 1)

    # -- radix matching ----------------------------------------------------

    def _descend(self, tokens: tuple):
        """Walk the trie along ``tokens``; returns ``(node, depth,
        partial, child)`` where ``depth`` tokens matched whole edges into
        ``node`` and ``partial`` further tokens matched into ``child``'s
        edge (0 when the walk stopped on a node boundary)."""
        node, depth = self._root, 0
        while depth < len(tokens):
            child = node.children.get(tokens[depth])
            if child is None:
                return node, depth, 0, None
            k = _common_len(child.edge, tokens, depth)
            if k < len(child.edge):
                return node, depth, k, child
            depth += k
            node = child
        return node, depth, 0, None

    @staticmethod
    def _any_entry(node: _Node) -> CacheEntry | None:
        """Some entry in ``node``'s subtree (deterministic: shallowest,
        then lowest first-token). Pruning keeps every leaf entry-bearing,
        so a non-root node always yields one."""
        stack = [node]
        while stack:
            n = stack.pop(0)
            if n.entry is not None:
                return n.entry
            stack.extend(n.children[t] for t in sorted(n.children))
        return None

    def match(self, tokens, *, max_match: int | None = None
              ) -> tuple[CacheEntry | None, int]:
        """Longest-prefix match: ``(donor_entry, match_len)``.

        ``match_len`` is the longest common prefix between ``tokens`` and
        ANY cached sequence (capped at ``max_match`` — the session caps
        at ``len(prompt) - 1`` so a warm suffix always re-emits the first
        token's logits); ``donor_entry`` is an entry whose tokens agree
        on that whole prefix. Returns ``(None, 0)`` below the hit
        threshold. Pure query: no refcount or recency side effects.
        """
        key = _tokens_key(tokens)
        if max_match is not None:
            key = key[:max(int(max_match), 0)]
        node, depth, partial, child = self._descend(key)
        m = depth + partial
        if m < self.min_match_tokens:
            return None, 0
        donor = self._any_entry(child if partial else node)
        if donor is None:
            return None, 0
        return donor, min(m, len(donor))

    # -- lease lifecycle ---------------------------------------------------

    def acquire(self, tokens, *,
                max_match: int | None = None) -> PrefixLease | None:
        """Match and pin: on a hit, bump the donor's refcount and return a
        lease; on a miss return None. A non-page-aligned match counts one
        copy-on-write (the reader's private copy of the partial page)."""
        entry, m = self.match(tokens, max_match=max_match)
        if entry is None:
            self.stats["misses"] += 1
            return None
        entry.refcount += 1
        self._tick += 1
        entry.tick = self._tick
        shared = (m // self.page_size) * self.page_size
        self.stats["hits"] += 1
        self.stats["hit_tokens"] += m
        if shared < m:
            self.stats["cow_copies"] += 1
        return PrefixLease(entry=entry, matched_tokens=m,
                           shared_tokens=shared, page_size=self.page_size)

    def release(self, lease: PrefixLease | None) -> None:
        """Drop one reader's hold (idempotent — a handle that is both
        finished and preempted, or released twice by shutdown paths,
        must not underflow the refcount)."""
        if lease is None or lease.released:
            return
        lease.released = True
        lease.entry.refcount = max(lease.entry.refcount - 1, 0)
        self.stats["releases"] += 1

    # -- insertion / eviction ----------------------------------------------

    def insert(self, tokens, state) -> bool:
        """Cache the post-prefill ``state`` under its token sequence.

        Already-cached sequences just refresh recency. Admission pressure
        is backed by LRU eviction of *unreferenced* entries; if the entry
        still cannot fit (everything resident is pinned, or it alone
        exceeds capacity) the insert is skipped — the cache never evicts
        a refcount > 0 entry. Returns True iff newly inserted.
        """
        key = _tokens_key(tokens)
        if not key:
            return False
        node, depth, partial, child = self._descend(key)
        if depth == len(key) and not partial and node.entry is not None:
            self._tick += 1
            node.entry.tick = self._tick
            return False
        pages = self.pages_for(len(key))
        if not self._make_room(pages):
            return False
        # walk again: the evictions may have pruned or re-compressed the
        # nodes of the first walk
        node, depth, partial, child = self._descend(key)
        if partial:
            # split child's edge at the divergence point
            node = self._split(node, child, partial)
            depth += partial
        target = self._insert_path(node, key[depth:])
        if target.entry is not None:  # split landed exactly on the key
            self._tick += 1
            target.entry.tick = self._tick
            return False
        self._next_id += 1
        self._tick += 1
        entry = CacheEntry(entry_id=self._next_id, tokens=key, state=state,
                           pages=pages, tick=self._tick)
        target.entry = entry
        self._entries[entry.entry_id] = entry
        self.stats["insertions"] += 1
        return True

    def _split(self, parent: _Node, child: _Node, at: int) -> _Node:
        """Split ``child``'s edge after ``at`` tokens; returns the new
        intermediate node."""
        mid = _Node(child.edge[:at])
        child.edge = child.edge[at:]
        parent.children[mid.edge[0]] = mid
        mid.children[child.edge[0]] = child
        return mid

    def _insert_path(self, node: _Node, rest: tuple) -> _Node:
        if not rest:
            return node
        child = _Node(rest)
        node.children[rest[0]] = child
        return child

    def _make_room(self, pages: int) -> bool:
        """Evict LRU refcount-0 entries until ``pages`` fit; False if the
        pinned residue leaves no room."""
        if pages > self.capacity_pages:
            return False
        while self.held_pages + pages > self.capacity_pages:
            if not self._evict_lru():
                return False
        return True

    def _evict_lru(self) -> bool:
        """Evict the least-recently-used unreferenced entry (never a
        refcount > 0 one). Returns False when nothing is evictable."""
        victims = [e for e in self._entries.values() if e.refcount == 0]
        if not victims:
            return False
        victim = min(victims, key=lambda e: e.tick)
        self._remove(victim)
        self.stats["evictions"] += 1
        return True

    def shed(self, pages: int) -> int:
        """Free at least ``pages`` pool pages by evicting unreferenced
        entries (the session calls this under pool pressure *before*
        preempting live requests). Returns the pages actually freed."""
        freed = 0
        while freed < pages:
            before = self.held_pages
            if not self._evict_lru():
                break
            freed += before - self.held_pages
        self.stats["shed_pages"] += freed
        return freed

    def _remove(self, entry: CacheEntry) -> None:
        del self._entries[entry.entry_id]
        # re-walk to the entry's node, then prune/re-compress the path
        path = [self._root]
        node, depth = self._root, 0
        key = entry.tokens
        while depth < len(key):
            node = node.children[key[depth]]
            path.append(node)
            depth += len(node.edge)
        assert node.entry is entry
        node.entry = None
        for i in range(len(path) - 1, 0, -1):
            n, parent = path[i], path[i - 1]
            if n.entry is not None:
                break
            if not n.children:
                del parent.children[n.edge[0]]
            elif len(n.children) == 1 and parent is not None:
                # merge the lone child up (path re-compression keeps
                # matching O(match length) as entries churn)
                (child,) = n.children.values()
                child.edge = n.edge + child.edge
                parent.children[child.edge[0]] = child
                if n.edge[0] != child.edge[0]:
                    del parent.children[n.edge[0]]
                break
            else:
                break

    def __repr__(self) -> str:
        return (f"PrefixCache(entries={len(self._entries)}, "
                f"held={self.held_pages}/{self.capacity_pages} pages x "
                f"{self.page_size} tokens, hit_rate={self.hit_rate:.2f})")
