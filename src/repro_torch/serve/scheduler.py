"""Scheduler: *when accesses issue* — slot admission and wave composition
(counterpart of the JAX package's ``serve/scheduler.py``).

Two shipped policies:

* ``FifoScheduler`` — free slots are filled from the queue head at the
  start of every step, each admission running a blocking single-prompt
  prefill before the decode wave is issued.
* ``OverlapScheduler`` — double-buffers prefill against the in-flight
  decode wave: the wave is launched first (a replay is asynchronous),
  then queued prompts are prefilled *while the wave is in flight* and
  parked in a ready buffer; they are installed into free slots at the
  next step boundary. Prompts are grouped by length, and admission is
  **paged-KV**: a ready request joins the current wave iff its
  page-padded state signature matches the wave's, so prompts of
  different raw lengths but the same length quantum share a wave, while
  a different quantum waits for the wave to drain.

On one card the overlap is pipelining against the asynchronous replay:
the prefill's host work runs while the card runs the wave, and its
device work queues behind the wave on the same stream (the session reads
the wave's tokens through an event recorded before the prefill, so the
read does not wait for it). Over a
:class:`~repro_torch.serve.mesh_backend.MeshBackend` the session's
``prefill_one`` / ``prefill_group`` resolve to the backend's donor
prefill, on the mesh's last rank, which hands the rows to every rank; on
one card the donor is the wave's own rank, so no second stream is added.
The scheduler itself is placement-blind, which keeps fifo and overlap
token-identical on every mesh shape.

On merge-free paths (dense backends, or sectored exact mode) both
schedulers produce the same token streams on the same request trace:
a slot's state is independent of the others, so *when* a request joins a
wave never changes *what* it generates, and a sampled request's draws
are keyed on (request_seed, position) only. Under the shared-prefix
demand merge a slot's sector predictions CAN depend on which
same-prefix slots are co-resident, so there the guarantee is only
trace-level.

Schedulers are **meter-transparent**: the telemetry hooks live in the
session's prefill/wave methods, which both schedulers drive through the
same entry points, and wave energy comes from deterministic host-side
counters, so fifo and overlap report identical joules for identical
token streams. A custom scheduler keeps this as long as it admits via
``prefill_one`` / ``prefill_group`` + ``install*``.
"""

from __future__ import annotations

import collections
from typing import Protocol, runtime_checkable


def _observe_schedule(scheduler, session) -> None:
    """Report queue pressure to the session's flight recorder, if any —
    discovered by getattr like the meter hooks, zero-cost absent.
    Called at the top of ``schedule()`` so the gauges describe the state
    the admission pass actually saw."""
    obs = getattr(session, "obs", None)
    if obs is not None:
        obs.on_schedule(queue_depth=len(session.queue),
                        ready=scheduler.pending(),
                        scheduler=getattr(scheduler, "name", "custom"))


@runtime_checkable
class Scheduler(Protocol):
    """Admission + wave-composition policy driven by ``ServeSession``."""

    def schedule(self, session) -> None:
        """Fill free slots before the wave launches."""
        ...

    def overlap(self, session) -> None:
        """Optional work while the decode wave is in flight."""
        ...

    def pending(self) -> int:
        """Requests held by the scheduler (prefilled, not yet installed)."""
        ...


class FifoScheduler:
    """Head-of-queue admission with blocking prefill (legacy behaviour).

    With a session :class:`~repro_torch.serve.pool.KVPagePool`, admission is
    additionally pool-gated: overcommit from the previous wave's growth
    is unwound first (``session.preempt_overcommitted`` — victims land
    back at the queue front), then the queue head admits only while its
    current KV need fits the pool. A blocked head pauses ALL admission
    (strict FIFO — no overtaking), which is what lets a preempted
    request resume before later arrivals.
    """

    name = "fifo"

    def schedule(self, session) -> None:
        session.preempt_overcommitted()
        _observe_schedule(self, session)
        for slot in session.free_slots():
            if not session.queue:
                break
            if not session.pool_admits(session.queue[0]):
                break  # pool full: wait for resident streams to drain
            handle = session.queue.popleft()
            token, state = session.prefill_one(handle)
            session.install(slot, handle, token, state)

    def overlap(self, session) -> None:
        pass

    def pending(self) -> int:
        return 0


class OverlapScheduler:
    """Prefill/decode overlap with a ready buffer and paged-KV admission.

    ``prefill_ahead`` bounds the ready buffer (default: the session's
    ``max_batch``) — prefilled-but-unadmitted requests hold device memory,
    so the lookahead is capped like the paper's LSQ depth.
    """

    name = "overlap"

    def __init__(self, prefill_ahead: int | None = None):
        if prefill_ahead is not None and prefill_ahead < 1:
            raise ValueError("prefill_ahead must be >= 1 (a zero budget "
                             "would never admit queued requests)")
        self.prefill_ahead = prefill_ahead
        self._ready: collections.deque = collections.deque()

    def pending(self) -> int:
        return sum(len(group) for group in self._ready)

    def schedule(self, session) -> None:
        session.preempt_overcommitted()
        _observe_schedule(self, session)
        self._install_ready(session)
        if not session.active_slots() and not self._ready and session.queue:
            # cold start: no wave in flight to overlap with — prefill
            # synchronously so the first wave doesn't idle
            self._prefill_queued(session, overlapped=False)
            self._install_ready(session)

    def overlap(self, session) -> None:
        if session.queue:
            # only count the stat when a wave is genuinely in flight: the
            # looped session blocks on its wave before calling overlap()
            self._prefill_queued(session,
                                 overlapped=session.wave_in_flight)

    def _budget(self, session) -> int:
        ahead = (self.prefill_ahead if self.prefill_ahead is not None
                 else session.max_batch)
        return ahead - self.pending()

    def _install_ready(self, session) -> None:
        # paged-KV admission, strictly head-of-line: the front group
        # installs iff its padded-state signature matches the in-flight
        # wave; a mismatched head PAUSES all admission (later groups may
        # not overtake it — otherwise steady same-quantum traffic could
        # starve it forever). With admission paused the active set only
        # shrinks, the wave drains, and the head is then accepted against
        # an empty wave. Each group installs as ONE multi-slot scatter; a
        # group larger than the free slots is split and its tail keeps its
        # place in line. A session page pool gates the same way: only the
        # group prefix the pool can hold right now installs; a fully
        # blocked head pauses admission until resident streams drain.
        free = session.free_slots()
        while self._ready and free:
            group = self._ready[0]
            if not session.wave_accepts(group.sig):
                break
            n = min(len(free), session.pool_admit_count(group.handles))
            if n == 0:
                break  # pool full: wait for resident streams to drain
            self._ready.popleft()
            if len(group) > n:
                group, tail = session.split_group(group, n)
                self._ready.appendleft(tail)
            session.install_group(free[:len(group)], group)
            free = free[len(group):]

    def _prefill_queued(self, session, *, overlapped: bool) -> int:
        budget = self._budget(session)
        taken = []
        while session.queue and len(taken) < budget:
            taken.append(session.queue.popleft())
        if not taken:
            return 0
        # one group prefill per length run, split at length
        # changes so admission order follows submission order; lengths
        # are EFFECTIVE (prompt + generated) so a preempted request's
        # resume re-prefill groups correctly. Prefix-cache hits break a
        # run too: only the session's singleton prefill path can seed
        # from a shared entry (a group prefills cold), so a hit
        # rides alone — order is still preserved, the hit just trades
        # group batching for skipping most of its prefill
        runs: list[list] = []
        prev_hit = False
        for handle in taken:
            hit = session.prefix_hit(handle) > 0
            if (runs and not hit and not prev_hit
                    and runs[-1][0].prefill_len == handle.prefill_len):
                runs[-1].append(handle)
            else:
                runs.append([handle])
            prev_hit = hit
        for handles in runs:
            self._ready.append(session.prefill_group(handles))
        if overlapped:
            session.stats["overlapped_prefills"] += len(taken)
        return len(taken)
