"""Legacy engine facade — thin compatibility shims over ``ServeSession``
(counterpart of the JAX package's ``serve/engine.py``).

``Engine`` (vectorized) and ``LoopedEngine`` (per-slot reference)
predate the ServeSession design; they keep the pre-redesign call sites
and the vectorized-vs-looped equivalence oracle working. Each shim
builds a :class:`~repro_torch.serve.backend.ServingBackend` from the
four loose callables, a :class:`~repro_torch.serve.policy.
HysteresisPolicy` from ``EngineConfig``, and drives a FIFO-scheduled
session with the legacy in-place contract (``Request.generated``
mutated, ``Request.done`` set), on ``device`` (None: the GPU).

New code should construct :class:`~repro_torch.serve.session.
ServeSession` directly.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.kernels import backend as kbackend
from repro_torch.serve.backend import ServingBackend
from repro_torch.serve.policy import HysteresisPolicy
from repro_torch.serve.scheduler import FifoScheduler
from repro_torch.serve.session import PREFIX_KEY_TOKENS, Request, ServeSession

__all__ = ["PREFIX_KEY_TOKENS", "Request", "EngineConfig", "Engine",
           "LoopedEngine"]


@dataclasses.dataclass
class EngineConfig:
    max_batch: int = 8
    sectored_min_occupancy: float = 0.5  # dynamic on/off threshold (§8.1)
    sectored_hysteresis: float = 0.125  # occupancy band below the threshold


class _EngineBase:
    """Shared shim plumbing; subclasses pick the wave flavor."""

    _vectorized: bool

    def __init__(self, prefill_fn: Callable, decode_fn: Callable,
                 sectored_decode_fn: Callable | None = None,
                 cfg: EngineConfig | None = None,
                 demand_merge_fn: Callable | None = None, *,
                 device=None):
        # cfg default is None (not a shared EngineConfig() instance): a
        # dataclass default in the signature would be constructed once and
        # aliased by every engine built without an explicit config
        self.cfg = cfg if cfg is not None else EngineConfig()
        backend = ServingBackend(prefill_fn, decode_fn, sectored_decode_fn,
                                 demand_merge_fn,
                                 device=kbackend.resolve_device(device))
        self.session = ServeSession(
            backend, max_batch=self.cfg.max_batch, scheduler=FifoScheduler(),
            policy=HysteresisPolicy(
                min_occupancy=self.cfg.sectored_min_occupancy,
                hysteresis=self.cfg.sectored_hysteresis),
            vectorized=self._vectorized)

    # legacy surface, delegated to the session -----------------------------

    def submit(self, req: Request) -> None:
        self.session.submit(req, bind_request=True)

    def step(self) -> int:
        return self.session.step()

    def run_until_drained(self, max_steps: int = 10_000):
        return self.session.run_until_drained(max_steps=max_steps)

    @property
    def queue(self) -> list[Request]:
        return [h.request for h in self.session.queue]

    @property
    def active(self) -> list[Request | None]:
        return [h.request if h is not None else None
                for h in self.session.slots]

    @property
    def occupancy(self) -> float:
        return self.session.occupancy

    @property
    def completion_order(self) -> list[int]:
        return self.session.completion_order

    @property
    def stats(self) -> dict[str, int]:
        return self.session.stats

    @stats.setter
    def stats(self, value: dict[str, int]) -> None:
        self.session.stats = value

    @property
    def _sectored_on(self) -> bool:
        return getattr(self.session.policy, "_on", False)

    def _select_path(self) -> bool:
        """Legacy hook: one policy decision against current occupancy."""
        if not self.session.backend.supports_sectored:
            return False
        return self.session.policy.decide(self.session.occupancy,
                                          self.session.stats).use_sectored


class Engine(_EngineBase):
    """Vectorized shim: ONE decode wave over all slots per step (see
    ``ServeSession`` with ``vectorized=True``)."""

    _vectorized = True

    @property
    def batched(self):
        """The wave buffer (slots on its batch axis)."""
        return self.session.batched


class LoopedEngine(_EngineBase):
    """Per-slot reference shim: ``max_batch`` sequential decode calls per
    step. Kept as the equivalence oracle for the vectorized wave."""

    _vectorized = False

    @property
    def states(self) -> list:
        return self.session.states
