"""SectorPolicy: *what the memory controller fetches* — the paper §8.1
dynamic Sectored-off mechanism as a pluggable decision object.

A ``SectorPolicy`` holds the on/off threshold, its hysteresis band and
the top-k page fraction behind one ``decide(occupancy, stats) ->
PathDecision`` call that the session makes once per wave.

Counterpart of the JAX package's ``serve/policy.py``. The coverage-driven
``AdaptiveSectorPolicy`` reads the telemetry recorder and waits for the
port's telemetry slice.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Protocol, runtime_checkable


@dataclasses.dataclass(frozen=True)
class PathDecision:
    """One wave's fetch plan.

    ``topk_frac`` is a hint for backends that can re-specialize their
    sectored step per fraction (None = backend default); ``merge_demands``
    gates the shared-prefix OR-merge before the fetch.
    """

    use_sectored: bool
    topk_frac: float | None = None
    merge_demands: bool = True


@runtime_checkable
class SectorPolicy(Protocol):
    def decide(self, occupancy: float,
               stats: Mapping[str, int]) -> PathDecision: ...


@dataclasses.dataclass
class HysteresisPolicy:
    """Dynamic sectored-on/off with a hysteresis guard band (§8.1).

    Switch on when occupancy reaches ``min_occupancy`` (throughput-bound
    regime: sector misses are paid back), switch off only when it falls
    strictly below ``min_occupancy - hysteresis`` — occupancy jitter inside
    the band cannot thrash paths. Edge semantics (covered in
    tests/test_serve.py): occupancy exactly at the threshold turns the
    sectored path ON; occupancy exactly at ``threshold - hysteresis``
    keeps it on (the off-switch is a strict ``<``).
    """

    min_occupancy: float = 0.5
    hysteresis: float = 0.125
    topk_frac: float | None = None
    _on: bool = dataclasses.field(default=False, init=False, repr=False)

    def decide(self, occupancy: float,
               stats: Mapping[str, int]) -> PathDecision:
        if self._on:
            if occupancy < self.min_occupancy - self.hysteresis:
                self._on = False
        elif occupancy >= self.min_occupancy:
            self._on = True
        return PathDecision(use_sectored=self._on, topk_frac=self.topk_frac)


@dataclasses.dataclass
class AlwaysDense:
    """Sectored path permanently off (latency-bound deployments)."""

    def decide(self, occupancy: float,
               stats: Mapping[str, int]) -> PathDecision:
        return PathDecision(use_sectored=False)


@dataclasses.dataclass
class AlwaysSectored:
    """Sectored path permanently on (bandwidth-bound deployments)."""

    topk_frac: float | None = None

    def decide(self, occupancy: float,
               stats: Mapping[str, int]) -> PathDecision:
        return PathDecision(use_sectored=True, topk_frac=self.topk_frac)
