"""Scheduler: *when accesses issue* — slot admission (counterpart of the
JAX package's ``serve/scheduler.py``).

This slice ports ``FifoScheduler``: free slots are filled from the queue
head at the start of every step, each admission running a blocking
single-prompt prefill before the decode wave. The prefill/decode
``OverlapScheduler`` and page-pool gating come with the pool slice.
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable


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
    """Head-of-queue admission with blocking prefill."""

    name = "fifo"

    def schedule(self, session) -> None:
        for slot in session.free_slots():
            if not session.queue:
                break
            handle = session.queue.popleft()
            token, state = session.prefill_one(handle)
            session.install(slot, handle, token, state)

    def overlap(self, session) -> None:
        pass

    def pending(self) -> int:
        return 0
