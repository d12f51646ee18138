"""Double-entry energy audit: command-replay joules vs the WaveMeter's
(counterpart of the JAX package's ``obs/audit.py``).

Every metered wave (and prefill) is charged twice, by two independent
accountants over the same host counters:

* the **meter** (``telemetry/meters.py``) — ``power.kv_fetch_energy`` /
  ``kv_append_energy`` totals, the books every BENCH file and telemetry
  report is built from;
* the **command ledger** (``obs/commands.py``) — per-command ACT/RD/WR
  aggregates synthesized from scratch (its own ceils, caps, partial-page
  and shared-fetch arithmetic), summed by kind.

The two must reconcile to :data:`AUDIT_REL_TOL` — in practice they agree
to ~1e-15, differing only in float association order, so the 1e-9 gate
has nine orders of headroom before it fires. Both ledgers share the
calibrated energy *primitives* (``model.act_energy`` etc.): the audit
proves the *attribution* — which rows, how many sectors, which co-reader
paid — not the Fig. 9 constants. A bug in either side's caps, sharing
amortization, or layer scaling shows up as a loud :class:`AuditError`
naming the entry and both values, the kind of self-consistency check the
meter cannot run on itself.

``bg_j``/``ref_j`` are *derived* entries: both sides charge average
power over the one command-timeline makespan, so they reconcile exactly
by construction — they document that the background window and the
latency model are the same model, not two.
"""

from __future__ import annotations

from typing import Mapping

#: relative reconciliation tolerance; float association-order noise is
#: ~1e-15, so a trip means a real attribution divergence
AUDIT_REL_TOL = 1e-9

#: absolute floor under which entries are considered reconciled (both
#: books agree the quantity is zero-ish; rel error is meaningless there)
AUDIT_ABS_FLOOR = 1e-30


class AuditError(AssertionError):
    """The two energy books disagree beyond tolerance."""


def rel_err(meter_j: float, command_j: float) -> float:
    """Symmetric relative error between the two books' entries."""
    scale = max(abs(meter_j), abs(command_j))
    if scale <= AUDIT_ABS_FLOOR:
        return 0.0
    return abs(meter_j - command_j) / scale


def reconcile(meter_side: Mapping[str, float],
              command_side: Mapping[str, float], *, where: str = "",
              rel_tol: float = AUDIT_REL_TOL) -> dict[str, dict[str, float]]:
    """Check every meter entry against its command-ledger counterpart.

    Returns the full ledger ``{entry: {"meter", "commands", "rel_err"}}``
    for reporting; raises :class:`AuditError` listing every failing entry
    if any exceeds ``rel_tol``. Keys must match exactly — an entry one
    book has and the other lacks is itself an audit failure.
    """
    missing = set(meter_side) ^ set(command_side)
    if missing:
        raise AuditError(
            f"energy audit{f' ({where})' if where else ''}: one-sided "
            f"entries {sorted(missing)} — both books must carry the same "
            f"accounts")
    ledger = {
        name: dict(meter=float(meter_side[name]),
                   commands=float(command_side[name]),
                   rel_err=rel_err(meter_side[name], command_side[name]))
        for name in sorted(meter_side)
    }
    bad = {n: e for n, e in ledger.items() if e["rel_err"] > rel_tol}
    if bad:
        lines = "\n".join(
            f"  {name}: meter={e['meter']:.17g} "
            f"commands={e['commands']:.17g} rel_err={e['rel_err']:.3e}"
            for name, e in bad.items())
        raise AuditError(
            f"energy audit failed{f' ({where})' if where else ''} "
            f"(tol {rel_tol:g}):\n{lines}")
    return ledger


def max_rel_err(ledger: Mapping[str, Mapping[str, float]]) -> float:
    """Worst entry of one reconciled ledger (0.0 for an empty one)."""
    return max((e["rel_err"] for e in ledger.values()), default=0.0)
