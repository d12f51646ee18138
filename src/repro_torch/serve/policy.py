"""SectorPolicy: *what the memory controller fetches* — the paper §8.1
dynamic Sectored-off mechanism as a pluggable decision object.

A ``SectorPolicy`` holds the on/off threshold, its hysteresis band and
the top-k page fraction behind one ``decide(occupancy, stats) ->
PathDecision`` call that the session makes once per wave.

Counterpart of the JAX package's ``serve/policy.py``. The coverage-driven
``AdaptiveSectorPolicy`` reads the telemetry recorder of a metered
backend (:mod:`repro_torch.telemetry`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Protocol, runtime_checkable


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


@dataclasses.dataclass
class AdaptiveSectorPolicy:
    """Coverage-driven fetch-width control: the paper's access-pattern-
    adaptive memory controller closed over the telemetry loop.

    Consumes the EMA coverage signal a
    :class:`~repro_torch.telemetry.recorder.TraceRecorder` maintains
    (``recorder`` is duck-typed: anything with an ``ema`` mapping works)
    and steers ``PathDecision.topk_frac`` toward a target attention-mass
    coverage with a deadband:

    * signal **above** ``target + deadband`` — the predictor's top-k
      already captures more mass than required: narrow the fraction (fetch
      fewer sectors, save ACT/RD energy);
    * signal **below** ``target - deadband`` — widen (the workload's
      attention is spread wider than the current budget);
    * inside the deadband, or before the first sectored wave has been
      recorded — hold (no thrash on noise, the hysteresis idea of §8.1
      applied to fetch *width* instead of the on/off toggle).

    The fraction is re-specialized per wave through
    ``SectoredKVBackend.sectored_fn_for`` (one step per distinct page
    budget, cached; on the card each is captured once as a CUDA graph), so
    adaptation costs one capture per *new* width and nothing after.

    ``signal`` picks the recorder field: ``"attn_mass"`` (default) is the
    predictor's own mass-capture estimate — honest right after exact-mode
    phases, biased high under long narrow runs, exactly like the paper's
    SHT which only observes fetched sectors; ``"sector_coverage"`` is the
    exact fetched/valid page ratio. With the default signal the policy
    falls back to sector coverage until a mass estimate exists.
    """

    recorder: Any
    target_coverage: float = 0.7
    deadband: float = 0.1
    frac_step: float = 0.125
    min_frac: float = 0.0625
    max_frac: float = 1.0
    init_frac: float = 0.5
    signal: str = "attn_mass"
    merge_demands: bool = True
    frac: float = dataclasses.field(init=False, repr=False)

    def __post_init__(self) -> None:
        if not self.min_frac <= self.init_frac <= self.max_frac:
            raise ValueError(
                f"init_frac {self.init_frac} outside "
                f"[{self.min_frac}, {self.max_frac}]")
        self.frac = self.init_frac

    def _coverage(self) -> float | None:
        ema = getattr(self.recorder, "ema", None) or {}
        value = ema.get(self.signal)
        if value is None and self.signal == "attn_mass":
            value = ema.get("sector_coverage")
        return value

    def decide(self, occupancy: float,
               stats: Mapping[str, int]) -> PathDecision:
        coverage = self._coverage()
        if coverage is not None:
            if coverage > self.target_coverage + self.deadband:
                self.frac = max(self.frac - self.frac_step, self.min_frac)
            elif coverage < self.target_coverage - self.deadband:
                self.frac = min(self.frac + self.frac_step, self.max_frac)
        return PathDecision(use_sectored=True, topk_frac=self.frac,
                            merge_demands=self.merge_demands)
