"""repro_torch.obs — deterministic serving observability (counterpart of
the JAX package's ``obs``).

:class:`FlightRecorder` traces every request's lifecycle as a span tree
on the virtual step clock and feeds a :class:`MetricsRegistry`;
:mod:`repro_torch.obs.export` renders both as JSONL and Perfetto JSON.
The whole layer is host-side bookkeeping discovered via optional hooks,
so enabling it cannot perturb token streams, logprobs, or metered joules
(the observer-effect oracle). In wall mode (``FlightRecorder(wall=True)``)
it also times the session's phases on the host clock and, on the card,
records CUDA events around the spans that enqueue device work; it still
launches no kernel and synchronizes nothing before
:meth:`FlightRecorder.resolve`, which places the device intervals on the
host clock after the window (:func:`write_wall_perfetto` draws them).

:mod:`repro_torch.obs.commands` synthesizes each metered wave's DRAM
command stream from the same host counters the meter converts to joules
and replays it through the DDR4 timing model to a modeled service time
(``dram_ns``); :mod:`repro_torch.obs.audit` reconciles the command
ledger's joules against the meter's (the double-entry energy audit).
"""

from .audit import AUDIT_REL_TOL, AuditError, max_rel_err, reconcile, rel_err
from .commands import (CommandTimeline, DramCommand, act_issue_span_ns,
                       background_energy, column_slot_ns, prefill_commands,
                       replay, replay_by_slot, wave_commands, with_refresh)
from .export import (TRACE_SCHEMA_VERSION, US_PER_STEP, command_trace_events,
                     to_trace_events, wall_trace_events, write_jsonl,
                     write_perfetto, write_wall_perfetto)
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .spans import SESSION_TRACK, FlightRecorder, idle_report

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "FlightRecorder", "SESSION_TRACK", "idle_report",
    "write_jsonl", "write_perfetto", "to_trace_events",
    "wall_trace_events", "write_wall_perfetto",
    "command_trace_events", "TRACE_SCHEMA_VERSION", "US_PER_STEP",
    "CommandTimeline", "DramCommand", "wave_commands", "prefill_commands",
    "replay", "replay_by_slot", "with_refresh", "background_energy",
    "column_slot_ns", "act_issue_span_ns",
    "AuditError", "AUDIT_REL_TOL", "reconcile", "max_rel_err", "rel_err",
]
