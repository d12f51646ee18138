"""Telemetry: per-wave DRAM energy accounting for the serving stack
(counterpart of the JAX package's ``telemetry``).

* :mod:`repro_torch.telemetry.meters` — :class:`WaveMeter` (per-wave
  counters -> joules and modeled DRAM time, per-request attribution) and
  :class:`MeteredBackend` (the opt-in decorator a ``ServeSession``
  discovers metering through).
* :mod:`repro_torch.telemetry.recorder` — :class:`TraceRecorder`, the
  ring-buffered per-wave trace with EMA coverage aggregates that
  :class:`~repro_torch.serve.policy.AdaptiveSectorPolicy` consumes, plus
  JSONL export.

Everything here is host code over host counters; joules and ``dram_ns``
are outputs of the DDR4 model, never measurements of the card.
"""

from repro_torch.telemetry.meters import (KVGeometry, MeteredBackend,
                                          WaveMeter, attn_mass_captured)
from repro_torch.telemetry.recorder import TraceRecorder

__all__ = ["KVGeometry", "MeteredBackend", "WaveMeter", "TraceRecorder",
           "attn_mass_captured"]
