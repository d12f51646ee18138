"""KVPagePool: the serving-layer KV page capacity model (counterpart of
the JAX package's ``serve/pool.py``, host code kept as it is there).

The paper's architecture makes the *fetch* fine-grained; capacity is still
a hard budget — a serving deployment has a fixed number of KV pages and
load beyond it must degrade gracefully, not refuse admission. The pool is
a deterministic host-side accountant over that budget:

* a request *holds* ``pages_for(prompt_tokens + emitted_tokens)`` pages
  while resident (its KV cache, rounded up to page granularity);
* admission is gated on the pages the request needs *now* (its effective
  prompt plus the token the next wave appends), not its worst case — the
  pool may overcommit against future growth;
* when growth overcommits the budget, the session preempts the
  youngest-admitted requests (``ServeSession.preempt_overcommitted``),
  dropping their pages and requeueing them at the queue front in
  submission order; they resume later by re-prefilling over
  ``prompt + generated`` (bit-identical on the exact decode path — see
  the session's ``preempt_overcommitted``);
* ``submit()`` rejects loudly any request whose *worst case*
  (``prompt + max_new_tokens``) exceeds the whole pool: it could never
  run to completion even alone, so admission would livelock.

The pool is deliberately stateless about *who* holds what — holdings are
derived from the session's live slot lengths, so the accountant cannot
drift from the truth it accounts. ``page_size`` defaults to the sectored
runtime's page quantum but is configurable: benchmarks and tests use
smaller pages to reach capacity pressure on short prompts.
"""

from __future__ import annotations

import dataclasses

#: default page quantum — mirrors runtime.sectored_decode.PAGE_SIZE without
#: importing the torch-heavy runtime from this leaf module (asserted equal in
#: tests/test_torch_capacity.py)
DEFAULT_PAGE_SIZE = 128


@dataclasses.dataclass
class KVPagePool:
    """Page-granular KV capacity: ``capacity_pages`` pages of
    ``page_size`` tokens each, shared by every resident request."""

    capacity_pages: int
    page_size: int = DEFAULT_PAGE_SIZE

    def __post_init__(self):
        if self.capacity_pages < 1:
            raise ValueError(
                f"capacity_pages must be >= 1, got {self.capacity_pages}")
        if self.page_size < 1:
            raise ValueError(
                f"page_size must be >= 1, got {self.page_size}")
        # peak concurrent demand ever seen (reporting only)
        self.peak_pages = 0

    def pages_for(self, n_tokens: int) -> int:
        """Pages covering ``n_tokens`` cached tokens (>= 1 per request)."""
        return max(-(-int(n_tokens) // self.page_size), 1)

    def observe(self, held_pages: int) -> None:
        """Record a concurrent-demand sample for peak reporting."""
        self.peak_pages = max(self.peak_pages, held_pages)
        # flight-recorder passthrough, installed by FlightRecorder.bind();
        # discovered by getattr like every optional hook, zero-cost absent
        obs = getattr(self, "obs", None)
        if obs is not None:
            obs.on_pool(held_pages)

    def fits(self, held_pages: int) -> bool:
        return held_pages <= self.capacity_pages

    def __repr__(self) -> str:
        return (f"KVPagePool(capacity={self.capacity_pages} pages x "
                f"{self.page_size} tokens, peak={self.peak_pages})")
