"""repro_torch.obs — the host-side DRAM command timeline and energy audit
(counterpart of part of the JAX package's ``obs``).

:mod:`repro_torch.obs.commands` synthesizes each metered wave's DRAM
command stream from the same host counters the meter converts to joules
and replays it through the DDR4 timing model to a modeled service time
(``dram_ns``); :mod:`repro_torch.obs.audit` reconciles the command
ledger's joules against the meter's (the double-entry energy audit). The
flight recorder (spans, metrics registry, exports) is not ported yet.
"""

from .audit import AUDIT_REL_TOL, AuditError, max_rel_err, reconcile, rel_err
from .commands import (CommandTimeline, DramCommand, act_issue_span_ns,
                       background_energy, column_slot_ns, prefill_commands,
                       replay, replay_by_slot, wave_commands, with_refresh)

__all__ = [
    "CommandTimeline", "DramCommand", "wave_commands", "prefill_commands",
    "replay", "replay_by_slot", "with_refresh", "background_energy",
    "column_slot_ns", "act_issue_span_ns",
    "AuditError", "AUDIT_REL_TOL", "reconcile", "max_rel_err", "rel_err",
]
