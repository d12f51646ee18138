"""ServeSession: the serving facade (counterpart of the JAX package's
``serve/session.py``) — backend, scheduler and policy composed per §8.1.

* the backend (:class:`~repro_torch.serve.backend.ServingBackend`) is how
  the card executes: prefill, dense decode, sectored decode, demand merge;
* the scheduler (:mod:`repro_torch.serve.scheduler`: FIFO, or prefill
  overlapped with the decode wave) is when requests are admitted;
* the policy (:mod:`repro_torch.serve.policy`) is what each wave fetches.

``submit()`` returns a :class:`StreamHandle` (the legacy ``Engine`` shims
in :mod:`repro_torch.serve.engine` opt back into in-place mutation of the
``Request`` via ``bind_request=True``).

Waves come in two flavors. Vectorized (the default): the reference
stacks per-slot states on a new leading axis and ``jit(vmap)``s a
per-slot step; here the slots ARE the batch axis of one state, the wave
buffer ``batched``. Looped (``vectorized=False``, the equivalence
oracle): each slot keeps its own batch-1 state in ``states[s]`` and the
backend's step runs once per slot. The vectorized wave is fused by
default (:func:`~repro_torch.serve.backend.make_fused_wave`: token
selection, stop guard and logprob on the device); ``fuse_wave=False``
keeps the pre-fused wave, whose logits come out and are selected outside
it (a host argmax for greedy waves, :func:`~repro_torch.sample.
select_tokens` for sampled ones, advancing the same counters). Sampled
tokens are keyed by ``(seed, position)``, so no stream depends on its
slot, its co-residents, the scheduler or the wave flavor.

Every buffer a wave runs on is allocated once and written in place
(admission, the demand merge, the wave), so on the card a wave is the
replay of a CUDA graph captured on it: the wave buffer and sampler rows
for vectorized waves, each slot's state for looped ones (a new request
is copied into the slot's state; a state of another shape replaces it
and drops the graphs captured on the old one, never rebinding them).

Two serving contracts ride on top, as in the reference:

* **EOS** — ``Request.stop_tokens`` finishes a request the moment it
  emits a stop token, on the host and inside the wave.
* **Capacity** — an optional :class:`~repro_torch.serve.pool.KVPagePool`
  bounds the resident KV pages. Admission waits while the pool is full;
  growth past the budget preempts the youngest-admitted requests
  (``preempt_overcommitted``, driven by the schedulers), which requeue
  at the queue front in submission order and later *resume*: a
  re-prefill over ``prompt + generated`` rebuilds their state and the
  sampling counter restarts at ``len(generated)``, so on the exact path a
  preempted stream equals its uncontended run.

An optional :class:`~repro_torch.serve.prefix.PrefixCache` seeds warm
admissions from a cached prefix (the backend's ``state_prefix``, a
copy) and prefills only the prompt suffix (``suffix_prefill``), bitwise
the cold prefill on the exact path. A group prefill (overlap scheduler)
runs each prompt through the backend's batch-1 prefill in turn: on the
card a batched prefill need not be bitwise the batch-1 one, and fifo ==
overlap rests on it.

Overlap on one stream: the wave's tokens and logprobs are queued for
copy to (pinned) host memory, with an event, before the scheduler's
overlapped prefill is enqueued behind the wave, and the read waits on
that event only.

Metering and the flight recorder are discovered, not configured: a
:class:`~repro_torch.telemetry.MeteredBackend` carries a ``WaveMeter``
and ``obs`` is a :class:`~repro_torch.obs.FlightRecorder`; both are
driven on the host from counters the session already keeps, never inside
a captured wave, and each hook is one ``is None`` check when off. A
recorder in wall mode also times the session's phases where the work
happens: ``step``, ``schedule``, each request's ``admit`` (``prefill``,
``first_token``, ``install``), ``wave`` (``merge``, ``replay``), ``read``
and ``emit``.

A :class:`~repro_torch.serve.mesh_backend.MeshBackend` extends the
vectorized flavor across a device mesh, SPMD: every rank runs this
session on the same schedule, and the session discovers the backend's
hooks by ``getattr`` as it discovers the meter — ``wave_for`` (the
meshed wave over this rank's block of slots, tokens gathered to every
rank), ``place_stacked`` (a new wave buffer to this rank's block),
``place_rows`` (the donor's prefilled rows to every rank, right after
each cold prefill) and ``vmapped_prefill`` (a group prefill on the
donor). Token streams, logprobs and joules stay bitwise across mesh
shapes.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Iterator

import numpy as np
import torch

from repro_torch.kernels import backend as kbackend
from repro_torch.parallel import sharding
from repro_torch.runtime.graphs import clone_tree, copy_tree_, leaves
from repro_torch.sample import (MAX_STOP_TOKENS, SamplerRows, SamplerSpec,
                                sample_token, select_tokens, token_logprob)
from repro_torch.serve.backend import (ServingBackend, make_fused_wave,
                                       make_prefused_wave)
from repro_torch.serve.policy import HysteresisPolicy
from repro_torch.serve.pool import KVPagePool
from repro_torch.serve.prefix import PrefixCache, PrefixLease
from repro_torch.serve.scheduler import FifoScheduler

PREFIX_KEY_TOKENS = 128  # tokens hashed into the shared-prefix group key


class StreamTruncated(RuntimeError):
    """A stream iterator / drain loop hit its step limit before the
    request (or session) completed."""


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int
    # None = greedy (as a spec with temperature 0)
    sampler: SamplerSpec | None = None
    # EOS contract: emitting any of these ids finishes the request (the
    # stop token itself IS emitted, nothing after it)
    stop_tokens: tuple = ()
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False

    @property
    def prefix_key(self) -> bytes:
        """Requests with equal keys hit the same leading KV pages."""
        return np.asarray(self.prompt[:PREFIX_KEY_TOKENS], np.int32).tobytes()


def state_signature(state) -> tuple:
    """Shape/dtype fingerprint of a decode state: two states with equal
    signatures can share a wave buffer."""
    return tuple((tuple(t.shape), str(t.dtype)) for t in leaves(state))


def stacked_row_signature(rows) -> tuple:
    """The :func:`state_signature` of a prefill group's rows (the port
    keeps a group as a list of batch-1 states) — the same format, so group
    and single-install admission keys cannot drift. Rows of different
    signatures raise ``ValueError``."""
    sigs = {state_signature(r) for r in rows}
    if len(sigs) != 1:
        raise ValueError(f"a prefill group's rows differ in signature: "
                         f"{sorted(sigs)}")
    return sigs.pop()


@dataclasses.dataclass
class PrefillGroup:
    """Prefilled requests waiting to be installed together.

    Produced by ``ServeSession.prefill_group`` and consumed by
    ``install_group``. ``logits`` ((n, vocab)) stays on the device: a
    scheduler prefilling under an in-flight wave must not wait on it;
    first tokens are read at install time.
    """

    handles: list[StreamHandle]
    logits: Any  # (n, vocab) device tensor
    states: list  # n batch-1 states
    sig: tuple  # per-row state signature (paged-KV admission key)

    def __len__(self) -> int:
        return len(self.handles)


class StreamHandle:
    """Streaming view of one request's generation: ``poll()`` returns new
    tokens without driving the session, ``tokens()`` steps it."""

    def __init__(self, session: "ServeSession", request: Request):
        self.request = request
        self.done = False
        self.stopped = False  # finished by a stop token (before quota)
        self._session = session
        self._tokens: list[int] = []
        self._cursor = 0
        self._bound = False  # legacy shims mirror state into the Request
        self._stop = frozenset(int(t) for t in (request.stop_tokens or ()))
        # preemption bookkeeping: submission order (requeue ordering) and
        # admission order (youngest-first victim selection)
        self._submit_index = -1
        self._admit_index = -1
        self.preemptions = 0
        # prefix-cache lease (warm admission): released at finish/preempt
        self._lease: PrefixLease | None = None
        # per-token raw logprobs, parallel to _tokens; the prefill token's
        # is stashed by the prefill path and consumed by _emit_first
        self._logprobs: list[float] = []
        self._first_logp = 0.0

    @property
    def rid(self) -> int:
        return self.request.rid

    @property
    def last_token(self) -> int:
        return self._tokens[-1]

    @property
    def prefill_len(self) -> int:
        """Tokens the next (re-)prefill of this request covers: the
        prompt plus everything already generated (non-empty only after a
        preemption — see ``ServeSession.effective_prompt``)."""
        return len(self.request.prompt) + len(self._tokens)

    def peek(self) -> list[int]:
        """All tokens produced so far (does not advance the poll cursor)."""
        return list(self._tokens)

    def poll(self) -> list[int]:
        """New tokens since the last ``poll()`` (non-blocking)."""
        new = self._tokens[self._cursor:]
        self._cursor += len(new)
        return new

    def logprobs(self) -> list[float]:
        """Raw log-probability of each emitted token, parallel to
        :meth:`peek`."""
        return list(self._logprobs)

    def tokens(self, max_steps: int | None = None) -> Iterator[int]:
        """Yield this request's tokens, stepping the session as needed;
        raises :class:`StreamTruncated` past ``max_steps`` session steps
        (default: the session's ``max_stream_steps``)."""
        limit = (self._session.max_stream_steps if max_steps is None
                 else max_steps)
        steps = 0
        while True:
            yield from self.poll()
            if self.done:
                return
            self._session.step()
            steps += 1
            if steps > limit:
                if self._session.obs is not None:
                    self._session.obs.on_truncated(self)
                raise StreamTruncated(
                    f"request {self.rid} did not complete within {limit} "
                    f"session steps: {len(self._tokens)} of "
                    f"{self.request.max_new_tokens} tokens emitted, "
                    f"{self.preemptions} preemptions; raise the limit via "
                    f"ServeSession(max_stream_steps=...) or "
                    f"tokens(max_steps=...)")

    def result(self, max_steps: int | None = None) -> list[int]:
        """Drive the session until this request completes; all tokens."""
        for _ in self.tokens(max_steps=max_steps):
            pass
        return self.peek()

    # -- telemetry (populated only when the session's backend is metered) --

    @property
    def telemetry(self) -> dict | None:
        """This request's metered stats (``energy_j``, ``tokens``,
        ``pages_fetched``, ``dram_ns``, ...) or None on an unmetered
        session."""
        meter = self._session.meter
        return None if meter is None else meter.request_stats(self.rid)

    @property
    def energy_j(self) -> float | None:
        """DRAM joules attributed to this request (None when unmetered)."""
        stats = self.telemetry
        return None if stats is None else stats["energy_j"]


class ServeSession:
    """Facade over backend + scheduler + policy; owns slots and waves."""

    def __init__(self, backend, *, max_batch: int = 8, scheduler=None,
                 policy=None, vectorized: bool = True, fuse_wave: bool = True,
                 page_pool: KVPagePool | None = None,
                 prefix_cache: PrefixCache | None = None, obs=None,
                 max_stream_steps: int = 10_000):
        if max_stream_steps < 1:
            raise ValueError(
                f"max_stream_steps must be >= 1, got {max_stream_steps}")
        self.backend = backend
        self.device = kbackend.resolve_device(getattr(backend, "device",
                                                      None))
        self.max_batch = max_batch
        self.scheduler = scheduler if scheduler is not None else FifoScheduler()
        self.policy = policy if policy is not None else HysteresisPolicy()
        self.vectorized = vectorized
        self.fuse_wave = fuse_wave
        # KV capacity model: None = unbounded; a pool gates admission and
        # arms preemption
        self.page_pool = page_pool
        # cross-request prefix cache: with one configured, a backend
        # without the seeding hooks is refused loudly
        self.prefix_cache = prefix_cache
        self._state_prefix = getattr(backend, "state_prefix", None)
        self._suffix_prefill = getattr(backend, "suffix_prefill", None)
        # every handle holding a live lease (installed, or prefilled ahead
        # in a scheduler's ready buffer): the admission deadlock breaker
        # enumerates the latter
        self._leased_handles: set[StreamHandle] = set()
        if prefix_cache is not None:
            if self._state_prefix is None or self._suffix_prefill is None:
                raise ValueError(
                    f"prefix_cache needs a backend exposing state_prefix() "
                    f"and suffix_prefill() (SectoredKVBackend does); "
                    f"{type(backend).__name__} cannot seed a warm admission")
            if (page_pool is not None
                    and page_pool.page_size != prefix_cache.page_size):
                raise ValueError(
                    f"prefix_cache page_size={prefix_cache.page_size} != "
                    f"page_pool page_size={page_pool.page_size}: shared and "
                    f"private pages must account in the same currency")
        self.max_stream_steps = max_stream_steps
        self._vocab = getattr(backend, "vocab", None)
        # a MeteredBackend carries a WaveMeter; a plain backend has none
        self.meter = getattr(backend, "meter", None)
        # mesh placement is discovered the same way: a MeshBackend carries
        # wave/placement hooks (wave_for, place_stacked, place_rows,
        # vmapped_prefill); a plain backend has none and every branch
        # below keeps the one-device behaviour
        self._backend_wave_for = getattr(backend, "wave_for", None)
        self._place_stacked = getattr(backend, "place_stacked", None)
        self._place_rows = getattr(backend, "place_rows", None)
        self._vmapped_prefill = getattr(backend, "vmapped_prefill", None)
        self.mesh = getattr(backend, "mesh", None)
        if not fuse_wave and self._backend_wave_for is not None:
            raise ValueError(
                "fuse_wave=False (the pre-fused reference wave) is a "
                "single-device ablation; a backend supplying wave_for "
                "(MeshBackend) always fuses token selection")
        if self.meter is not None and hasattr(self.meter, "mesh_shape"):
            # provenance stamp reflects the mesh THIS session's waves run
            # on (None when unmeshed) — set here, not at wrapper
            # construction, so a meter reused across sessions always
            # reports the placement that actually executed
            self.meter.mesh_shape = (
                tuple(sharding.mesh_axes(self.mesh).values())
                if self.mesh is not None else None)
        self.queue: collections.deque[StreamHandle] = collections.deque()
        self.slots: list[StreamHandle | None] = [None] * max_batch
        self.completion_order: list[int] = []
        self.stats = self._zero_stats()
        # vectorized waves: the wave's state (slots are its batch axis)
        # and the sampler rows beside it
        self.batched = None
        self._batched_sig = None
        self._sampler_rows = (SamplerRows.init(max_batch, device=self.device)
                              if vectorized else None)
        # looped waves: one batch-1 state per slot (None when vacant) over
        # the slot's own buffer, kept across admissions
        self.states: list = [None] * max_batch
        self._slot_buffers: list = [None] * max_batch
        self._wave_cache: dict[tuple, object] = {}
        self._host_buffers: dict[tuple, torch.Tensor] = {}
        self.wave_in_flight = False  # True between dispatch and token read
        self._submit_seq = 0  # submission order (preemption requeue key)
        self._admit_seq = 0  # admission order (youngest-first victims)
        # flight recorder: host bookkeeping only, so enabling it cannot
        # change streams, logprobs or joules
        self.obs = obs
        if obs is not None:
            obs.bind(self)

    @staticmethod
    def _zero_stats() -> dict[str, int]:
        return dict(decode_steps=0, sectored_steps=0, completed=0, waves=0,
                    sectored_waves=0, merged_slots=0, overlapped_prefills=0,
                    prefill_calls=0, preemptions=0, eos_stops=0)

    def reset_stats(self) -> None:
        self.stats = self._zero_stats()

    # -- request lifecycle ------------------------------------------------

    def submit(self, request: Request, *,
               bind_request: bool = False) -> StreamHandle:
        """Queue a request; returns its streaming handle. Degenerate
        requests are rejected loudly.

        ``bind_request=True`` restores the legacy contract of the
        ``Engine`` shims: tokens are mirrored into ``request.generated``
        (the same list) and ``request.done`` is set on completion.
        """
        self._validate(request)
        handle = StreamHandle(self, request)
        handle._submit_index = self._submit_seq
        self._submit_seq += 1
        if bind_request:
            handle._tokens = request.generated
            handle._bound = True
        self.queue.append(handle)
        if self.obs is not None:
            self.obs.on_submit(handle)
        return handle

    def _validate(self, request: Request) -> None:
        prompt = np.asarray(request.prompt)
        if prompt.size == 0:
            raise ValueError(f"request {request.rid}: empty prompt")
        if request.max_new_tokens < 1:
            raise ValueError(
                f"request {request.rid}: max_new_tokens must be >= 1, got "
                f"{request.max_new_tokens} (the prefill always emits one "
                f"token)")
        stop = tuple(int(t) for t in (request.stop_tokens or ()))
        if len(stop) > MAX_STOP_TOKENS:
            raise ValueError(
                f"request {request.rid}: {len(stop)} stop tokens exceed the "
                f"wave-side mask width MAX_STOP_TOKENS={MAX_STOP_TOKENS}")
        bad = [t for t in stop
               if t < 0 or (self._vocab is not None and t >= self._vocab)]
        if bad:
            bound = (f"[0, {self._vocab})" if self._vocab is not None
                     else ">= 0")
            raise ValueError(
                f"request {request.rid}: stop tokens {bad} outside vocab "
                f"({bound}) — they could never match an emitted token")
        capacity = getattr(self.backend, "token_capacity", None)
        rows = capacity(prompt.size) if capacity is not None else None
        if rows is not None and prompt.size + request.max_new_tokens > rows:
            raise ValueError(
                f"request {request.rid}: {prompt.size} prompt + "
                f"{request.max_new_tokens} new tokens exceed the "
                f"{rows}-token attention cache its state holds (past it "
                f"an append would write nothing)")
        if self.page_pool is not None:
            worst = self.page_pool.pages_for(
                prompt.size + request.max_new_tokens)
            if worst > self.page_pool.capacity_pages:
                raise ValueError(
                    f"request {request.rid}: worst-case KV footprint "
                    f"({worst} pages for {prompt.size} prompt + "
                    f"{request.max_new_tokens} new tokens) exceeds the "
                    f"page pool ({self.page_pool.capacity_pages} pages) — "
                    f"it could never run to completion even alone")

    @property
    def occupancy(self) -> float:
        return sum(h is not None for h in self.slots) / self.max_batch

    def active_slots(self) -> list[int]:
        return [s for s, h in enumerate(self.slots) if h is not None]

    def free_slots(self) -> list[int]:
        return [s for s, h in enumerate(self.slots) if h is None]

    @property
    def idle(self) -> bool:
        return (not self.queue and not self.active_slots()
                and not self.scheduler.pending())

    # -- prefill / admission (driven by the scheduler) --------------------

    @staticmethod
    def effective_prompt(handle: StreamHandle) -> np.ndarray:
        """The tokens a (re-)prefill of this request covers: the prompt,
        plus everything already generated when the request was preempted.
        The exact prefill makes the appends the uncontended run made, so a
        resumed stream continues bitwise on the exact path."""
        prompt = np.asarray(handle.request.prompt, np.int32)
        if not handle._tokens:
            return prompt
        return np.concatenate(
            [prompt, np.asarray(handle._tokens, np.int32)])

    def prefix_hit(self, handle: StreamHandle) -> int:
        """Peek: tokens a warm admission of this request would reuse
        (0 = cold). Pure query; the lease is taken at prefill time, and
        an entry evicted in between turns the hit back into a cold
        prefill (safe, never wrong)."""
        if self.prefix_cache is None or handle._tokens:
            return 0
        prompt = np.asarray(handle.request.prompt)
        _, m = self.prefix_cache.match(prompt, max_match=len(prompt) - 1)
        return m

    def _prefill_states(self, handle: StreamHandle, prompt: np.ndarray):
        """Prefill one prompt, warm when the prefix cache can seed it.

        Returns ``(logits (1, vocab), state, lease)``. A warm admission
        copies a donor entry's state cut to the matched length ``m``
        (``state_prefix``) and runs only ``prompt[m:]`` through the exact
        step a cold prefill runs (``suffix_prefill``). The match is capped
        at ``len(prompt) - 1`` so the suffix is never empty. Resumed
        re-prefills stay cold: their prompt includes generated tokens.
        """
        lease = None
        if (self.prefix_cache is not None and not handle._tokens
                and len(prompt) > 1):
            lease = self.prefix_cache.acquire(prompt,
                                              max_match=len(prompt) - 1)
        if lease is None:
            logits, state = self.backend.prefill_fn(prompt[None, :])
            if self._place_rows is not None:
                state = self._place_rows(state)  # donor -> every rank
            return logits, state, None
        m = lease.matched_tokens
        seed = self._state_prefix(lease.entry.state, m)
        logits, state = self._suffix_prefill(seed, prompt[None, m:])
        return logits, state, lease

    def _take_lease(self, handle: StreamHandle, lease) -> None:
        handle._lease = lease
        if lease is not None:
            self._leased_handles.add(handle)

    def _record_prefill(self, handle: StreamHandle, n_tokens: int) -> None:
        lease = handle._lease
        self.meter.record_prefill(
            handle.rid, n_tokens, overlapped=self.wave_in_flight,
            resumed=bool(handle._tokens),
            cached_tokens=lease.matched_tokens if lease is not None else 0)

    def prefill_one(self, handle: StreamHandle):
        """Blocking single-prompt prefill; returns (first_token, state)."""
        obs = self.obs
        prompt = self.effective_prompt(handle)
        if obs is not None:
            obs.on_admit_begin(handle)
            obs.wall_open("prefill", handle.rid, tokens=len(prompt))
        logits, state, lease = self._prefill_states(handle, prompt)
        if obs is not None:
            obs.wall_close("prefill", handle.rid)
        self._take_lease(handle, lease)
        self.stats["prefill_calls"] += 1
        if self.prefix_cache is not None and not handle._tokens:
            # fresh admissions (cold AND warm) insert their full-prompt
            # state; a duplicate just refreshes recency
            self.prefix_cache.insert(prompt, state)
        if self.meter is not None:
            self._record_prefill(handle, len(prompt))
        if obs is not None:
            obs.wall_open("first_token", handle.rid)
        tok = self._first_token(handle, logits[0])
        handle._first_logp = self._logp_of(logits[0], tok)
        if obs is not None:
            obs.wall_close("first_token", handle.rid)
        return tok, state

    @staticmethod
    def _logp_of(logits_row, tok: int) -> float:
        """Raw logprob of one chosen token: the wave's ``token_logprob``
        at unit batch, where the logits lie."""
        row = logits_row.reshape(1, -1)
        return float(token_logprob(
            row, torch.tensor([int(tok)], device=row.device)).item())

    @staticmethod
    def _first_token(handle: StreamHandle, logits_row) -> int:
        """The prefill-emitted token: first-max argmax for a greedy
        request; for a sampled one the sampling kernel on the logits'
        device at RNG counter ``len(tokens)`` (0 on a fresh admission,
        the resume position after a preemption)."""
        spec = handle.request.sampler
        if spec is None or spec.is_greedy:
            return int(torch.argmax(logits_row.float()).item())
        return sample_token(logits_row, spec, position=len(handle._tokens))

    def prefill_group(self, handles: list[StreamHandle]) -> PrefillGroup:
        """Prefill same-length prompts and keep them together.

        Lengths are *effective* (prompt + generated), so resumed requests
        group with fresh ones of the same total length. Each prompt goes
        through the backend's batch-1 prefill in turn (a singleton takes
        the ``prefill_one`` path, warm when the cache hits; a larger group
        is cold, as the reference's vmapped one), and nothing here waits
        on the device — see :class:`PrefillGroup`. Counts one prefill call
        per group, as the reference's one group dispatch does.
        """
        obs = self.obs
        prompts = [self.effective_prompt(h) for h in handles]
        lengths = {len(p) for p in prompts}
        if len(lengths) != 1:
            raise ValueError(f"prefill_group needs equal prompt lengths, "
                             f"got {sorted(lengths)}")
        self.stats["prefill_calls"] += 1
        if obs is not None:
            for h in handles:
                obs.on_admit_begin(h)
        if len(handles) == 1:
            # the one branch that can go warm (schedulers route cache hits
            # here via prefix_hit); a larger group prefills cold
            if obs is not None:
                obs.wall_open("prefill", handles[0].rid,
                              tokens=len(prompts[0]))
            row_logits, state, lease = self._prefill_states(handles[0],
                                                            prompts[0])
            if obs is not None:
                obs.wall_close("prefill", handles[0].rid)
            self._take_lease(handles[0], lease)
            rows = [(row_logits, state)]
        elif self._vmapped_prefill is not None:
            # a mesh backend's group prefill runs on its donor rank
            if obs is not None:
                obs.wall_open("prefill", rids=tuple(h.rid for h in handles),
                              tokens=sum(map(len, prompts)))
            group_logits, states = self._vmapped_prefill(prompts)
            if self._place_rows is not None:
                states = self._place_rows(states)  # donor -> every rank
            if obs is not None:
                obs.wall_close("prefill")
            rows = [(group_logits[j:j + 1], state)
                    for j, state in enumerate(states)]
        else:
            rows = []
            for h, p in zip(handles, prompts):
                if obs is not None:
                    obs.wall_open("prefill", h.rid, tokens=len(p))
                rows.append(self.backend.prefill_fn(p[None, :]))
                if obs is not None:
                    obs.wall_close("prefill", h.rid)
        logits = [row[0] for row in rows]
        states = [row[1] for row in rows]
        if self.prefix_cache is not None:
            for h, p, state in zip(handles, prompts, states):
                if not h._tokens:
                    self.prefix_cache.insert(p, state)
        if self.meter is not None:
            for h, p in zip(handles, prompts):
                self._record_prefill(h, len(p))
        return PrefillGroup(list(handles), torch.cat(logits), states,
                            stacked_row_signature(states))

    @staticmethod
    def split_group(group: PrefillGroup,
                    k: int) -> tuple[PrefillGroup, PrefillGroup]:
        """Split a prefill group when fewer than ``len(group)`` slots are
        free."""
        head = PrefillGroup(group.handles[:k], group.logits[:k],
                            group.states[:k], group.sig)
        tail = PrefillGroup(group.handles[k:], group.logits[k:],
                            group.states[k:], group.sig)
        return head, tail

    def wave_accepts(self, sig: tuple) -> bool:
        """Paged-KV admission check: can a state with this signature join
        the current wave? Looped slots are independent, so always;
        vectorized waves need a matching buffer unless no slot is
        active."""
        return (not self.vectorized or self.batched is None
                or self._batched_sig == sig or not self.active_slots())

    def _prepare_wave_buffer(self, sig: tuple, row_shape_of) -> None:
        """(Re)build the wave buffer for a row signature, or raise if the
        signature cannot join the in-flight wave. A rebuilt buffer drops
        the cached waves, whose graphs were captured on the old one."""
        if (self.batched is None
                or (self._batched_sig != sig and not self.active_slots())):
            self.batched = row_shape_of()
            if self._place_stacked is not None:
                # born on the mesh: this rank keeps its block, and the
                # admission writes below land in it
                self.batched = self._place_stacked(self.batched)
            self._batched_sig = sig
            self._wave_cache.clear()
        elif self._batched_sig != sig:
            raise ValueError(
                f"state signature {sig} cannot join the in-flight wave "
                f"(wave signature {self._batched_sig}); use a paged-KV "
                f"aware scheduler (OverlapScheduler) for mixed quanta")

    def _install_slot_state(self, slot: int, state) -> None:
        """Looped admission: copy a batch-1 state into the slot's own
        buffer, in place, so the slot's captured steps stay bound to it; a
        state of another signature replaces the buffer (a copy: prefill
        outputs may be cached entries) and drops those steps."""
        buf = self._slot_buffers[slot]
        if buf is not None and state_signature(buf) == state_signature(state):
            copy_tree_(buf, state)
        else:
            buf = clone_tree(state)
            self._slot_buffers[slot] = buf
            self._wave_cache = {k: w for k, w in self._wave_cache.items()
                                if k[:2] != ("slot", slot)}
        self.states[slot] = buf

    def install(self, slot: int, handle: StreamHandle, first_token: int,
                state) -> None:
        """Place one prefilled request (a batch-1 state) into a slot and
        emit its first token (the FIFO admission path)."""
        obs = self.obs
        if obs is not None:
            obs.wall_open("install", handle.rid)
        if self.vectorized:
            self._prepare_wave_buffer(
                state_signature(state),
                lambda: state.zeros_batch(self.max_batch))
            self.batched.set_row(slot, state)
            self._scatter_sampler_rows([slot], [handle])
        else:
            self._install_slot_state(slot, state)
        if obs is not None:
            obs.wall_close("install", handle.rid)
        self._emit_first(slot, handle, first_token)
        if obs is not None:
            obs.wall_close("admit", handle.rid)

    def install_group(self, slots: list[int], group: PrefillGroup) -> None:
        """Admit a whole prefill group: its rows into the slots and one
        sampler-row scatter. First tokens are read here, each selected as
        ``prefill_one`` selects it (so fifo and overlap emit the same
        tokens and logprobs)."""
        if len(slots) != len(group):
            raise ValueError(f"{len(group)} prefilled requests for "
                             f"{len(slots)} slots")
        obs = self.obs
        if obs is not None:
            obs.wall_open("install", rids=tuple(h.rid for h in group.handles))
        if self.vectorized:
            self._prepare_wave_buffer(
                group.sig,
                lambda: group.states[0].zeros_batch(self.max_batch))
            for slot, state in zip(slots, group.states):
                self.batched.set_row(slot, state)
            self._scatter_sampler_rows(slots, group.handles)
        else:
            for slot, state in zip(slots, group.states):
                self._install_slot_state(slot, state)
        if obs is not None:
            obs.wall_close("install")
        for j, (slot, handle) in enumerate(zip(slots, group.handles)):
            if obs is not None:
                obs.wall_open("first_token", handle.rid)
            tok = self._first_token(handle, group.logits[j])
            handle._first_logp = self._logp_of(group.logits[j], tok)
            if obs is not None:
                obs.wall_close("first_token", handle.rid)
            self._emit_first(slot, handle, tok)
            if obs is not None:
                obs.wall_close("admit", handle.rid)

    def _scatter_sampler_rows(self, slots: list[int], handles) -> None:
        """Admission scatter for the per-slot sampler state: each handle's
        spec lands in its slot with the RNG counter one past the tokens
        already emitted (1 when fresh; ``len(generated) + 1`` on a resume)
        and its stop set as the wave-side EOS mask. Rows of vacated slots
        stay stale and inert until the next admission rewrites them."""
        rows = SamplerRows.from_specs(
            [h.request.sampler for h in handles],
            [len(h._tokens) + 1 for h in handles],
            [h.request.stop_tokens for h in handles], device=self.device)
        self._sampler_rows.scatter_(slots, rows)

    def _emit_first(self, slot: int, handle: StreamHandle,
                    first_token: int) -> None:
        """Activate a slot and emit the prefill token; a request whose
        quota or stop set the prefill token already meets completes here
        without burning a decode wave."""
        self.slots[slot] = handle
        handle._admit_index = self._admit_seq
        self._admit_seq += 1
        if self.obs is not None:
            # before the prefill token lands: the recorder tells a resume
            # from a fresh admission by the pre-emit token count
            self.obs.on_admit(slot, handle)
        if self.page_pool is not None:
            self.page_pool.observe(self._held_pages_total())
        handle._tokens.append(first_token)
        handle._logprobs.append(handle._first_logp)
        if first_token in handle._stop:
            self._finish(slot, stopped=True)
        elif len(handle._tokens) >= handle.request.max_new_tokens:
            self._finish(slot)

    def _release_lease(self, handle: StreamHandle) -> None:
        """Drop a handle's hold on its shared entry (idempotent)."""
        if handle._lease is not None:
            self.prefix_cache.release(handle._lease)
            handle._lease = None
        self._leased_handles.discard(handle)

    def _vacate(self, slot: int) -> None:
        self.slots[slot] = None
        if not self.vectorized:
            self.states[slot] = None

    def _finish(self, slot: int, *, stopped: bool = False) -> None:
        handle = self.slots[slot]
        handle.done = True
        # last reader out frees the shared pages
        self._release_lease(handle)
        if stopped:
            handle.stopped = True
            self.stats["eos_stops"] += 1
        if handle._bound:
            handle.request.done = True
        self._vacate(slot)
        self.completion_order.append(handle.rid)
        self.stats["completed"] += 1
        if self.obs is not None:
            self.obs.on_finish(slot, handle,
                               reason="eos" if stopped else "quota")

    # -- KV page capacity (pool-gated admission + preemption) -------------

    def _held_pages_total(self, extra_tokens: int = 0) -> int:
        """Pages all resident requests hold, each grown by
        ``extra_tokens`` (1 = the append the next wave makes), derived
        from live slot lengths on every call. A leased slot's complete
        shared pages are charged once, to the cache entry
        (``PrefixCache.held_pages``); the slot counts its private rest."""
        total = 0
        for h in self.slots:
            if h is None:
                continue
            pages = self.page_pool.pages_for(h.prefill_len + extra_tokens)
            lease = h._lease
            if lease is not None and not lease.released:
                pages = max(pages - lease.shared_pages, 1)
            total += pages
        if self.prefix_cache is not None:
            total += self.prefix_cache.held_pages
        return total

    def _shed_for(self, held: int) -> int:
        """Evict unreferenced cache entries until ``held`` fits (pages
        freed returned): sharing backs off before live work does."""
        if self.prefix_cache is None:
            return 0
        overflow = held - self.page_pool.capacity_pages
        return self.prefix_cache.shed(overflow) if overflow > 0 else 0

    def _admission_need(self, handle: StreamHandle) -> int:
        """Pages this handle would hold if installed now (effective prompt
        + the prefill's token); a handle already leasing a live entry
        (prefilled ahead) charges only its private rest, its shared pages
        being in the entry's charge already."""
        need = self.page_pool.pages_for(handle.prefill_len + 1)
        lease = handle._lease
        if lease is not None and not lease.released:
            need = max(need - lease.shared_pages, 1)
        return need

    def _break_idle_leases(self) -> int:
        """Deadlock breaker of last resort: release the leases of handles
        NOT installed in a slot (prefilled, in a scheduler's ready
        buffer), whose entries may pin exactly the pages admission waits
        for. Their states are copies, so they survive their donors."""
        installed = {id(h) for h in self.slots if h is not None}
        broken = 0
        for h in list(self._leased_handles):
            if id(h) not in installed:
                self._release_lease(h)
                broken += 1
        return broken

    def pool_admits(self, handle: StreamHandle) -> bool:
        """Can this request be admitted *now*? Its current need must fit
        next to everyone's current holdings (not its worst case: the pool
        overcommits against growth and preemption unwinds it)."""
        if self.page_pool is None:
            return True
        need = self._admission_need(handle)
        if self.page_pool.fits(self._held_pages_total() + need):
            return True
        self._shed_for(self._held_pages_total() + need)
        if self.page_pool.fits(self._held_pages_total() + need):
            return True
        if (not any(s is not None for s in self.slots)
                and self._break_idle_leases() > 0):
            need = self._admission_need(handle)
            self._shed_for(self._held_pages_total() + need)
            return self.page_pool.fits(self._held_pages_total() + need)
        return False

    def pool_admit_count(self, handles: list[StreamHandle]) -> int:
        """Longest prefix of ``handles`` admissible together right now
        (the group form of :meth:`pool_admits`)."""
        if self.page_pool is None:
            return len(handles)
        held = self._held_pages_total()
        n = 0
        for h in handles:
            need = self._admission_need(h)
            if not self.page_pool.fits(held + need):
                freed = self._shed_for(held + need)
                held -= freed
                if (not self.page_pool.fits(held + need) and n == 0
                        and not any(s is not None for s in self.slots)
                        and self._break_idle_leases() > 0):
                    # nothing active to drain, nothing left to shed: the
                    # blocking pages are pinned by ready-buffer leases
                    need = self._admission_need(h)
                    self._shed_for(self._held_pages_total() + need)
                    held = self._held_pages_total()
                if not self.page_pool.fits(held + need):
                    break
            held += need
            n += 1
        return n

    def preempt_overcommitted(self) -> int:
        """Unwind pool overcommit before the next wave grows every slot.

        In order of cost: shed unreferenced cache entries, then preempt
        the youngest-admitted request (victims requeue at the queue FRONT
        in submission order). Never below one active request: a lone
        request always fits (``submit`` refused any that could not); if
        the survivor still overcommits because its lease pins a shared
        entry, the lease is broken and the next pass sheds the entry.
        Returns the number of requests preempted.
        """
        if self.page_pool is None:
            return 0
        victims: list[StreamHandle] = []
        while True:
            active = [(s, h) for s, h in enumerate(self.slots)
                      if h is not None]
            held = self._held_pages_total(extra_tokens=1)
            if self.page_pool.fits(held):
                break
            if self._shed_for(held) > 0:
                continue
            if len(active) > 1:
                slot, _ = max(active, key=lambda sh: sh[1]._admit_index)
                victims.append(self._preempt(slot))
                continue
            if (active and active[0][1]._lease is not None
                    and not active[0][1]._lease.released):
                self._release_lease(active[0][1])
                continue
            break
        if victims:
            for h in sorted(victims, key=lambda h: h._submit_index,
                            reverse=True):
                self.queue.appendleft(h)
            self.stats["preemptions"] += len(victims)
        return len(victims)

    def _preempt(self, slot: int) -> StreamHandle:
        """Vacate a slot WITHOUT finishing its request: its pages are freed
        (the buffer keeps stale rows the next admission overwrites) and
        the handle keeps its tokens for the resume re-prefill."""
        handle = self.slots[slot]
        handle.preemptions += 1
        handle._admit_index = -1
        # the resume re-prefill is cold, so the hold on the entry ends
        self._release_lease(handle)
        self._vacate(slot)
        if self.meter is not None:
            self.meter.record_eviction(
                handle.rid, kv_tokens=handle.prefill_len,
                kv_pages=self.page_pool.pages_for(handle.prefill_len))
        if self.obs is not None:
            self.obs.on_preempt(slot, handle)
        return handle

    # -- demand merge (shared-prefix OR-merge) ----------------------------

    def _group_ids(self) -> np.ndarray:
        """(max_batch,) int32: slots whose requests share the first
        ``PREFIX_KEY_TOKENS`` prompt tokens, or lease the same cache
        entry, get the leader slot's index; free slots keep their own."""
        gids = np.arange(self.max_batch, dtype=np.int32)
        leaders: dict[Any, int] = {}
        for slot, handle in enumerate(self.slots):
            if handle is None:
                continue
            lease = handle._lease
            key = (("e", lease.entry.entry_id)
                   if lease is not None and not lease.released
                   else ("p", handle.request.prefix_key))
            gids[slot] = leaders.setdefault(key, slot)
        return gids

    def _shared_groups(self, active: list[int]) -> list[dict] | None:
        """Co-resident readers of each shared cache entry, for the
        meter's shared-fetch amortization: ``[{"slots": [...],
        "shared_tokens": n}, ...]`` (groups of one amortize nothing)."""
        if self.prefix_cache is None:
            return None
        by_entry: dict[int, list[tuple[int, int]]] = {}
        for s in active:
            lease = self.slots[s]._lease
            if lease is None or lease.released or lease.shared_tokens <= 0:
                continue
            by_entry.setdefault(lease.entry.entry_id, []).append(
                (s, lease.shared_tokens))
        groups = [dict(slots=[s for s, _ in members],
                       shared_tokens=min(t for _, t in members))
                  for members in by_entry.values() if len(members) >= 2]
        return groups or None

    def _merge_groups(self, active: list[int]) -> np.ndarray:
        """Group ids for a sectored wave + merged_slots accounting, shared
        by both wave flavors."""
        gids = self._group_ids()
        n_groups = len({int(gids[s]) for s in active})
        self.stats["merged_slots"] += len(active) - n_groups
        return gids

    def _merge_demands(self, active: list[int]) -> None:
        if self.vectorized:
            gids = self._merge_groups(active)
            copy_tree_(self.batched,
                       self.backend.merge_demands(self.batched, gids))
            return
        if len(active) <= 1:
            return
        # looped: stack the active slots, pool, write each row back in
        # place; leader slot ids are remapped to stack-local indices
        gids = self._merge_groups(active)
        remap: dict[int, int] = {}
        sub_gids = np.asarray(
            [remap.setdefault(int(gids[s]), j)
             for j, s in enumerate(active)], np.int32)
        stacked = self.states[active[0]].zeros_batch(len(active))
        for j, s in enumerate(active):
            stacked.set_row(j, self.states[s])
        merged = self.backend.merge_demands(stacked, sub_gids)
        for j, s in enumerate(active):
            self.states[s].set_row(0, merged.row(j))

    # -- wave execution ---------------------------------------------------

    def _wave_for(self, fn, sampled: bool = False):
        """The vectorized wave for a step, cached per ``(id(fn),
        sampled)``: fused greedy waves carry no sampling math, and the
        sampled flavor's greedy branch is the same argmax. Pre-fused waves
        select outside, so both flavors share one."""
        key = (id(fn), sampled and self.fuse_wave)
        wave = self._wave_cache.get(key)
        if wave is None:
            if not self.fuse_wave:
                wave = make_prefused_wave(fn)
            elif self._backend_wave_for is not None:
                wave = self._backend_wave_for(fn, sampled=sampled)
            else:
                wave = make_fused_wave(fn, sampled=sampled)
            self._wave_cache[key] = wave
        return wave

    def _slot_step(self, fn, slot: int):
        """The looped step of one slot, bound to that slot's state."""
        key = ("slot", slot, id(fn))
        step = self._wave_cache.get(key)
        if step is None:
            step = self._wave_cache[key] = make_prefused_wave(fn)
        return step

    def _wave_sampled(self, active: list[int]) -> bool:
        """True when any active slot needs stochastic selection."""
        return any(self.slots[s].request.sampler is not None
                   and not self.slots[s].request.sampler.is_greedy
                   for s in active)

    def step(self) -> int:
        """Admit + one decode wave. Returns tokens produced."""
        obs = self.obs
        if obs is None:
            return self._step()
        obs.wall_open("step")
        try:
            return self._step()
        finally:
            obs.wall_close("step")

    def _step(self) -> int:
        obs = self.obs
        if obs is not None:
            obs.advance()  # the virtual step clock every span keys on
            obs.wall_open("schedule")
        self.scheduler.schedule(self)
        if obs is not None:
            obs.wall_close("schedule")
        active = self.active_slots()
        if not active:
            return 0
        if obs is not None:
            obs.wall_open("wave")
        decision = self.policy.decide(self.occupancy, self.stats)
        use_sectored = bool(decision.use_sectored
                            and self.backend.supports_sectored)
        if (use_sectored and decision.merge_demands
                and self.backend.demand_merge_fn is not None):
            if obs is not None:
                obs.wall_open("merge")
            self._merge_demands(active)
            if obs is not None:
                obs.wall_close("merge")
        fn = (self.backend.sectored_fn_for(decision.topk_frac)
              if use_sectored else self.backend.decode_fn)
        sampled = self._wave_sampled(active)
        self.stats["waves"] += 1
        if use_sectored:
            self.stats["sectored_waves"] += 1
        t0 = time.perf_counter() if self.meter is not None else 0.0
        if self.vectorized:
            next_tok, logps = self._run_vectorized(active, fn, sampled)
        else:
            if obs is not None:
                obs.wall_open("replay")
            next_tok, logps = self._run_looped(active, fn)
            if obs is not None:
                # each slot's token was read: the device has drained
                obs.wall_close("wave", anchor=True)
            self.scheduler.overlap(self)
        # wall_s brackets the wave, the overlap and the token read; it
        # never enters joules or dram_ns. The wave info is taken before
        # _emit_wave vacates finished slots, the meter driven after it
        wall_s = time.perf_counter() - t0 if self.meter is not None else 0.0
        wave_info = (self._meter_wave_info(active, decision, use_sectored)
                     if self.meter is not None else None)
        active_rids = ([(s, self.slots[s].rid) for s in active]
                       if obs is not None else None)
        if obs is not None:
            obs.wall_open("emit")
        produced = self._emit_wave(active, next_tok, logps, use_sectored)
        if obs is not None:
            obs.wall_close("emit")
        if wave_info is not None:
            self.meter.record_wave(wall_s=wall_s, **wave_info)
        if obs is not None:
            energy = (self.meter.recorder.window(1)[-1]
                      if self.meter is not None else None)
            timeline = (self.meter.last_timeline
                        if self.meter is not None else None)
            obs.on_wave(active_rids=active_rids, produced=produced,
                        sectored=use_sectored, energy=energy,
                        timeline=timeline)
        return produced

    def _host_buffer(self, t: torch.Tensor) -> torch.Tensor:
        """A host tensor shaped like ``t``, pinned when ``t`` is on the
        card (so a non-blocking copy into it is asynchronous), kept for
        the next wave."""
        key = (tuple(t.shape), t.dtype)
        buf = self._host_buffers.get(key)
        if buf is None:
            buf = torch.empty(t.shape, dtype=t.dtype,
                              pin_memory=t.device.type == "cuda")
            self._host_buffers[key] = buf
        return buf

    def _read_over_overlap(self, *tensors) -> list[np.ndarray]:
        """Queue copies of the wave's outputs to host memory, let the
        scheduler overlap its prefill work with the wave, then wait for
        the copies alone (an event recorded right after them) and return
        them. The overlapped prefill queues behind the wave on the same
        stream, so the read never waits for it."""
        obs = self.obs
        bufs = [self._host_buffer(t) for t in tensors]
        for buf, t in zip(bufs, tensors):
            buf.copy_(t, non_blocking=True)
        event = None
        if any(t.device.type == "cuda" for t in tensors):
            event = torch.cuda.Event()
            event.record()
        if obs is not None:
            obs.wall_close("wave")
        self.wave_in_flight = True
        try:
            self.scheduler.overlap(self)
        finally:
            self.wave_in_flight = False
        if obs is not None:
            obs.wall_open("read")
        if event is not None:
            event.synchronize()
        if obs is not None:
            # the copies are in: the device has drained (unless the
            # scheduler queued a prefill behind them)
            obs.wall_close("read", anchor=True)
        return [buf.numpy().copy() for buf in bufs]

    def _run_vectorized(self, active: list[int], fn, sampled: bool):
        """One vectorized wave over the wave buffer; returns host
        ``(tokens (max_batch,), logprobs (max_batch,))``.

        Fused (the default): tokens and logprobs come out of the wave.
        Pre-fused (``fuse_wave=False``): the wave's logits come out; a
        sampled wave selects with ``select_tokens`` on the device,
        advancing the sampler rows as the fused wave does; a greedy one
        takes the first-max argmax over the logits pulled to the host and
        leaves the rows alone (greedy draws never read them).
        """
        desired = np.zeros((self.max_batch, 1), np.int32)
        for s in active:
            desired[s, 0] = self.slots[s].last_token
        tok_in = torch.as_tensor(desired, device=self.device)
        wave = self._wave_for(fn, sampled)
        rows = self._sampler_rows
        if self.obs is not None:
            self.obs.wall_open("replay")  # closed with the wave
        if self.fuse_wave:
            toks, logps = self._read_over_overlap(wave(self.batched, tok_in,
                                                       rows), rows.logp)
            return toks[:, 0], logps
        logits = wave(self.batched, tok_in)
        if sampled:
            toks, advanced = select_tokens(logits, rows)
            copy_tree_(rows, advanced)
            toks, logps = self._read_over_overlap(toks, rows.logp)
            return toks.reshape(self.max_batch), logps
        (host_logits,) = self._read_over_overlap(logits.float())
        next_tok = np.argmax(host_logits, axis=-1)
        logps = token_logprob(logits, torch.as_tensor(
            next_tok, device=logits.device))
        return next_tok.astype(np.int32), logps.cpu().numpy()

    def _run_looped(self, active: list[int], fn
                    ) -> tuple[np.ndarray, np.ndarray]:
        """One looped wave: the step once per active slot on its batch-1
        state, each token selected as a prefill's first token is."""
        next_tok = np.zeros((self.max_batch,), np.int32)
        logps = np.zeros((self.max_batch,), np.float32)
        for s in active:
            handle = self.slots[s]
            last = torch.tensor([[handle.last_token]], dtype=torch.int32,
                                device=self.device)
            logits = self._slot_step(fn, s)(self.states[s], last)
            # the sampling counter: len(_tokens) tokens emitted so far is
            # the position of the one drawn now
            next_tok[s] = self._first_token(handle, logits[0])
            logps[s] = self._logp_of(logits[0], int(next_tok[s]))
        return next_tok, logps

    def _meter_wave_info(self, active: list[int], decision,
                         use_sectored: bool) -> dict:
        """Host-side wave descriptor for ``WaveMeter.record_wave``.

        Positions come from counts the session already keeps (prompt
        length + emitted tokens), never from the device: at attend time a
        slot's cache length is ``len(prompt) + len(tokens) - 1`` (the
        prefill token is emitted before the first wave).
        """
        k_for = getattr(self.backend, "k_for", None)
        k_pages = (k_for(decision.topk_frac)
                   if use_sectored and k_for is not None else None)
        if k_pages is not None:
            # narrow budgets fetch one extra probe page per wave (the SHT
            # refresh); record_wave caps per-slot fetches at the slot's
            # valid pages, so full-coverage slots never overpay
            probe_for = getattr(self.backend, "probe_pages_for", None)
            if probe_for is not None:
                k_pages += probe_for(k_pages)
        slots = [(s, self.slots[s].rid,
                  len(self.slots[s].request.prompt)
                  + len(self.slots[s]._tokens) - 1)
                 for s in active]
        views = (self._meter_state_views(active)
                 if use_sectored and k_pages is not None else None)
        return dict(sectored=use_sectored, k_pages=k_pages, slots=slots,
                    state_views=views,
                    shared_groups=self._shared_groups(active))

    def _meter_state_views(self, active: list[int]) -> dict | None:
        """Per-slot ``(table (L, Hkv, P), position)`` host arrays for the
        attention-mass estimate, or None for a state without a predictor
        table. The wave buffer's table is ``(L, slots, Hkv, P)``: a slot's
        rows are ``table[:, s]`` (a looped slot's state has batch 1). The
        copies are taken after the wave's tokens were read and are host
        copies, never views, since the next replay writes the same buffer.
        """
        def host(t):
            return t.detach().to("cpu", copy=True).numpy()
        if self.batched is not None:  # vectorized: the wave buffer
            table = getattr(self.batched, "table", None)
            if table is None or table.ndim != 4:
                return None
            table, position = host(table), host(self.batched.position)
            return {s: (table[:, s], position[s]) for s in active}
        views = {}
        for s in active:
            table = getattr(self.states[s], "table", None)
            if table is None or table.ndim != 4:
                return None
            views[s] = (host(table)[:, 0], host(self.states[s].position)[0])
        return views

    def _emit_wave(self, active: list[int], next_tok: np.ndarray,
                   logps: np.ndarray, use_sectored: bool) -> int:
        produced = 0
        for s in active:
            handle = self.slots[s]
            tok = int(next_tok[s])
            handle._tokens.append(tok)
            handle._logprobs.append(float(logps[s]))
            produced += 1
            self.stats["decode_steps"] += 1
            if use_sectored:
                self.stats["sectored_steps"] += 1
            if tok in handle._stop:
                self._finish(s, stopped=True)
            elif len(handle._tokens) >= handle.request.max_new_tokens:
                self._finish(s)
        return produced

    def run_until_drained(self, max_steps: int | None = None) -> dict:
        """Step until every queued request completes; the bound (default:
        ``max_stream_steps``) raises :class:`StreamTruncated`."""
        limit = self.max_stream_steps if max_steps is None else max_steps
        steps = 0
        while not self.idle:
            self.step()
            steps += 1
            if steps > limit:
                if self.obs is not None:
                    self.obs.on_truncated()
                raise StreamTruncated(
                    f"session did not drain within {limit} steps "
                    f"(queued={len(self.queue)}, "
                    f"active={len(self.active_slots())}); raise the limit "
                    f"via ServeSession(max_stream_steps=...) or "
                    f"run_until_drained(max_steps=...)")
        return self.stats


def make_session(backend_or_fns, *, max_batch: int = 8, scheduler=None,
                 policy=None, vectorized: bool = True, fuse_wave: bool = True,
                 page_pool: KVPagePool | None = None,
                 prefix_cache: PrefixCache | None = None, obs=None,
                 max_stream_steps: int = 10_000) -> ServeSession:
    """Convenience constructor accepting a backend or the legacy 4-tuple
    ``(prefill_fn, decode_fn, sectored_fn, demand_merge_fn)``."""
    if isinstance(backend_or_fns, (tuple, list)):
        backend_or_fns = ServingBackend(*backend_or_fns)
    return ServeSession(backend_or_fns, max_batch=max_batch,
                        scheduler=scheduler, policy=policy,
                        vectorized=vectorized, fuse_wave=fuse_wave,
                        page_pool=page_pool, prefix_cache=prefix_cache,
                        obs=obs, max_stream_steps=max_stream_steps)
