"""ServeSession: the serving facade (counterpart of the JAX package's
``serve/session.py``) — backend, scheduler and policy composed per §8.1.

* the backend (:class:`~repro_torch.serve.backend.ServingBackend`) is how
  the card executes: prefill, dense decode, sectored decode, demand merge;
* the scheduler (:class:`~repro_torch.serve.scheduler.FifoScheduler`) is
  when requests are admitted;
* the policy (:mod:`repro_torch.serve.policy`) is what each wave fetches.

``submit()`` returns a :class:`StreamHandle`. Every wave is vectorized and
fused: the reference stacks per-slot states on a new leading axis and
``jit(vmap)``s a per-slot step; here the slots ARE the batch axis of one
state, and the wave (:func:`~repro_torch.serve.backend.make_fused_wave`)
selects tokens on the device, applies the stop guard and returns each
token's logprob. A wave whose slots are all greedy runs the greedy
flavor; one with any sampled request runs the sampled flavor, whose
greedy branch is the same argmax, so a greedy stream does not depend on
its co-residents. Sampled tokens are keyed by ``(seed, position)``: the
prefill token draws at counter ``len(tokens)`` (0 when fresh), each wave
at the slot's row counter. The EOS contract (``Request.stop_tokens``) is
enforced on the host and inside the wave, as in the reference.

The wave buffer (``batched``) and the sampler rows are allocated once and
only ever written in place (admission, the demand merge, the wave), so on
the card a wave is the replay of a CUDA graph captured on them. A state
joins the buffer by its shape signature, as in the reference: a request
whose prefilled state has another shape (a dense prompt in another
1024-token bucket) rebuilds the buffer when no slot is active and raises
``ValueError`` otherwise (FIFO has no paged admission).

Metering is discovered, not configured, as in the reference: a
:class:`~repro_torch.telemetry.MeteredBackend` carries a ``WaveMeter``,
which the session drives on the host after each prefill and each wave,
from counters it already keeps (prompt lengths, emitted tokens, the
policy's page budget), and from a host copy of the predictor table taken
after the wave's tokens were read. Nothing of it runs inside a captured
wave; a plain backend has no meter and every hook is one ``is None``
check.

This slice serves greedy and sampled requests through the FIFO
scheduler. The reference's page pool, prefix cache, flight recorder,
mesh, pre-fused (``fuse_wave=False``) and looped (``vectorized=False``)
waves raise ``NotImplementedError`` when asked for.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Iterator

import numpy as np
import torch

from repro_torch.kernels import backend as kbackend
from repro_torch.runtime.graphs import copy_tree_, leaves
from repro_torch.sample import MAX_STOP_TOKENS, SamplerRows, SamplerSpec
from repro_torch.sample import sample_token, token_logprob
from repro_torch.serve.backend import make_fused_wave
from repro_torch.serve.policy import HysteresisPolicy
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


class StreamHandle:
    """Streaming view of one request's generation: ``poll()`` returns new
    tokens without driving the session, ``tokens()`` steps it."""

    def __init__(self, session: "ServeSession", request: Request):
        self.request = request
        self.done = False
        self.stopped = False  # finished by a stop token (before quota)
        self._session = session
        self._tokens: list[int] = []
        self._logprobs: list[float] = []
        self._first_logp = 0.0
        self._cursor = 0
        self._stop = frozenset(int(t) for t in (request.stop_tokens or ()))

    @property
    def rid(self) -> int:
        return self.request.rid

    @property
    def last_token(self) -> int:
        return self._tokens[-1]

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
                raise StreamTruncated(
                    f"request {self.rid} did not complete within {limit} "
                    f"session steps: {len(self._tokens)} of "
                    f"{self.request.max_new_tokens} tokens emitted; raise "
                    f"the limit via ServeSession(max_stream_steps=...) or "
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


def state_signature(state) -> tuple:
    """Shape/dtype fingerprint of a decode state: two states with equal
    signatures can share a wave buffer."""
    return tuple((tuple(t.shape), str(t.dtype)) for t in leaves(state))


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported to repro_torch yet")


class ServeSession:
    """Facade over backend + scheduler + policy; owns slots and waves."""

    def __init__(self, backend, *, max_batch: int = 8, scheduler=None,
                 policy=None, vectorized: bool = True, fuse_wave: bool = True,
                 page_pool=None, prefix_cache=None, obs=None,
                 max_stream_steps: int = 10_000):
        for name, asked in (("page_pool", page_pool is not None),
                            ("prefix_cache", prefix_cache is not None),
                            ("obs (flight recorder)", obs is not None),
                            ("vectorized=False (looped wave)", not vectorized),
                            ("fuse_wave=False (pre-fused wave)",
                             not fuse_wave),
                            ("a mesh backend",
                             getattr(backend, "wave_for", None) is not None)):
            if asked:
                raise _not_ported(name)
        if max_stream_steps < 1:
            raise ValueError(
                f"max_stream_steps must be >= 1, got {max_stream_steps}")
        self.backend = backend
        self.device = getattr(backend, "device", None)
        if self.device is None:
            self.device = kbackend.resolve_device(None)
        self.max_batch = max_batch
        self.scheduler = scheduler if scheduler is not None else FifoScheduler()
        self.policy = policy if policy is not None else HysteresisPolicy()
        self.max_stream_steps = max_stream_steps
        self._vocab = getattr(backend, "vocab", None)
        # a MeteredBackend carries a WaveMeter; a plain backend has none
        self.meter = getattr(backend, "meter", None)
        self.queue: collections.deque[StreamHandle] = collections.deque()
        self.slots: list[StreamHandle | None] = [None] * max_batch
        self.completion_order: list[int] = []
        self.stats = self._zero_stats()
        # the wave's state: slots are its batch axis
        self.batched = None
        self._batched_sig = None
        self._sampler_rows = SamplerRows.init(max_batch, device=self.device)
        self._wave_cache: dict[tuple, object] = {}

    @staticmethod
    def _zero_stats() -> dict[str, int]:
        return dict(decode_steps=0, sectored_steps=0, completed=0, waves=0,
                    sectored_waves=0, merged_slots=0, overlapped_prefills=0,
                    prefill_calls=0, preemptions=0, eos_stops=0)

    def reset_stats(self) -> None:
        self.stats = self._zero_stats()

    # -- request lifecycle ------------------------------------------------

    def submit(self, request: Request) -> StreamHandle:
        """Queue a request; returns its streaming handle. Degenerate
        requests are rejected loudly."""
        self._validate(request)
        handle = StreamHandle(self, request)
        self.queue.append(handle)
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

    def prefill_one(self, handle: StreamHandle):
        """Blocking single-prompt prefill; returns (first_token, state)."""
        prompt = np.asarray(handle.request.prompt, np.int32)
        logits, state = self.backend.prefill_fn(prompt[None, :])
        self.stats["prefill_calls"] += 1
        if self.meter is not None:
            self.meter.record_prefill(handle.rid, len(prompt))
        tok = self._first_token(handle, logits[0])
        handle._first_logp = float(token_logprob(
            logits[:1], torch.tensor([tok], device=logits.device)).item())
        return tok, state

    @staticmethod
    def _first_token(handle: StreamHandle, logits_row) -> int:
        """The prefill-emitted token: first-max argmax for a greedy
        request; for a sampled one the sampling kernel on the logits'
        device at RNG counter ``len(tokens)`` (0 on a fresh admission)."""
        spec = handle.request.sampler
        if spec is None or spec.is_greedy:
            return int(torch.argmax(logits_row.float()).item())
        return sample_token(logits_row, spec, position=len(handle._tokens))

    def wave_accepts(self, sig: tuple) -> bool:
        """Can a state with this signature join the current wave? Yes
        when there is no buffer, the signatures match or no slot is
        active."""
        return (self.batched is None or self._batched_sig == sig
                or not self.active_slots())

    def _prepare_wave_buffer(self, sig: tuple, row_shape_of) -> None:
        """(Re)build the wave buffer for a row signature, or raise if the
        signature cannot join the in-flight wave. A rebuilt buffer drops
        the cached waves, whose graphs were captured on the old one."""
        if (self.batched is None
                or (self._batched_sig != sig and not self.active_slots())):
            self.batched = row_shape_of()
            self._batched_sig = sig
            self._wave_cache.clear()
        elif self._batched_sig != sig:
            raise ValueError(
                f"state signature {sig} cannot join the in-flight wave "
                f"(wave signature {self._batched_sig}); mixed quanta need "
                f"a paged-KV aware scheduler (the reference's "
                f"OverlapScheduler, a later slice of the port)")

    def install(self, slot: int, handle: StreamHandle, first_token: int,
                state) -> None:
        """Place one prefilled request (a batch-1 state) into a slot and
        emit its first token."""
        self._prepare_wave_buffer(state_signature(state),
                                  lambda: state.zeros_batch(self.max_batch))
        self.batched.set_row(slot, state)
        rows = SamplerRows.from_specs([handle.request.sampler],
                                      [len(handle._tokens) + 1],
                                      [handle.request.stop_tokens],
                                      device=self.device)
        self._sampler_rows.scatter_([slot], rows)
        self._emit_first(slot, handle, first_token)

    def _emit_first(self, slot: int, handle: StreamHandle,
                    first_token: int) -> None:
        """Activate a slot and emit the prefill token; a request whose
        quota or stop set the prefill token already meets completes here
        without burning a decode wave."""
        self.slots[slot] = handle
        handle._tokens.append(first_token)
        handle._logprobs.append(handle._first_logp)
        if first_token in handle._stop:
            self._finish(slot, stopped=True)
        elif len(handle._tokens) >= handle.request.max_new_tokens:
            self._finish(slot)

    def _finish(self, slot: int, *, stopped: bool = False) -> None:
        handle = self.slots[slot]
        handle.done = True
        if stopped:
            handle.stopped = True
            self.stats["eos_stops"] += 1
        self.slots[slot] = None
        self.completion_order.append(handle.rid)
        self.stats["completed"] += 1

    # -- demand merge (shared-prefix OR-merge) ----------------------------

    def _group_ids(self) -> np.ndarray:
        """(max_batch,) int32: slots whose requests share the first
        ``PREFIX_KEY_TOKENS`` prompt tokens get the leader slot's index;
        free slots keep their own."""
        gids = np.arange(self.max_batch, dtype=np.int32)
        leaders: dict[bytes, int] = {}
        for slot, handle in enumerate(self.slots):
            if handle is not None:
                gids[slot] = leaders.setdefault(handle.request.prefix_key,
                                                slot)
        return gids

    def _merge_demands(self, active: list[int]) -> None:
        gids = self._group_ids()
        n_groups = len({int(gids[s]) for s in active})
        self.stats["merged_slots"] += len(active) - n_groups
        copy_tree_(self.batched, self.backend.merge_demands(self.batched,
                                                            gids))

    # -- wave execution ---------------------------------------------------

    def _wave_for(self, fn, sampled: bool = False):
        """The fused wave for a step, cached per ``(id(fn), sampled)``:
        greedy waves carry no sampling math; the sampled flavor's greedy
        branch is the same argmax."""
        key = (id(fn), sampled)
        wave = self._wave_cache.get(key)
        if wave is None:
            wave = make_fused_wave(fn, sampled=sampled)
            self._wave_cache[key] = wave
        return wave

    def _wave_sampled(self, active: list[int]) -> bool:
        """True when any active slot needs stochastic selection."""
        return any(self.slots[s].request.sampler is not None
                   and not self.slots[s].request.sampler.is_greedy
                   for s in active)

    def step(self) -> int:
        """Admit + one decode wave. Returns tokens produced."""
        self.scheduler.schedule(self)
        active = self.active_slots()
        if not active:
            return 0
        decision = self.policy.decide(self.occupancy, self.stats)
        use_sectored = bool(decision.use_sectored
                            and self.backend.supports_sectored)
        if (use_sectored and decision.merge_demands
                and self.backend.demand_merge_fn is not None):
            self._merge_demands(active)
        fn = (self.backend.sectored_fn_for(decision.topk_frac)
              if use_sectored else self.backend.decode_fn)
        self.stats["waves"] += 1
        if use_sectored:
            self.stats["sectored_waves"] += 1
        desired = np.zeros((self.max_batch, 1), np.int32)
        for s in active:
            desired[s, 0] = self.slots[s].last_token
        tok_in = torch.as_tensor(desired, device=self.device)
        t0 = time.perf_counter() if self.meter is not None else 0.0
        wave = self._wave_for(fn, self._wave_sampled(active))
        out = wave(self.batched, tok_in, self._sampler_rows)
        next_tok = out.cpu().numpy()[:, 0]
        logps = self._sampler_rows.logp.cpu().numpy()
        self.scheduler.overlap(self)
        # wall_s brackets the wave and the token copy only; it never
        # enters joules or dram_ns. The wave info is taken before
        # _emit_wave vacates finished slots, the meter driven after it
        wall_s = time.perf_counter() - t0 if self.meter is not None else 0.0
        wave_info = (self._meter_wave_info(active, decision, use_sectored)
                     if self.meter is not None else None)
        produced = self._emit_wave(active, next_tok, logps, use_sectored)
        if wave_info is not None:
            self.meter.record_wave(wall_s=wall_s, **wave_info)
        return produced

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
                    state_views=views, shared_groups=None)

    def _meter_state_views(self, active: list[int]) -> dict | None:
        """Per-slot ``(table (L, Hkv, P), position)`` host arrays for the
        attention-mass estimate. The wave buffer's table is ``(L, slots,
        Hkv, P)``: a slot's rows are ``table[:, s]`` (the reference stacks
        slots first and takes ``table[s]``). The copy is taken after the
        wave's tokens were read (that read already synced) and is a host
        copy, never a view, since the next replay writes the same buffer.
        """
        table = getattr(self.batched, "table", None)
        if table is None or table.ndim != 4:
            return None
        table = table.detach().to("cpu", copy=True).numpy()
        position = self.batched.position.detach().to("cpu",
                                                     copy=True).numpy()
        return {s: (table[:, s], position[s]) for s in active}

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
                raise StreamTruncated(
                    f"session did not drain within {limit} steps "
                    f"(queued={len(self.queue)}, "
                    f"active={len(self.active_slots())}); raise the limit "
                    f"via ServeSession(max_stream_steps=...) or "
                    f"run_until_drained(max_steps=...)")
        return self.stats
