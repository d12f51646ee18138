"""DRAM command timeline: synthesis from host counters + modeled replay
(counterpart of the JAX package's ``obs/commands.py``).

The paper's headline is energy *and* performance: sectored activation
draws fewer tFAW power-delivery tokens per ACT (§4.1), so the controller
legally schedules ACTs faster — the mechanism behind the paper's average
17% speedup. ``core/timing.py`` has modeled that token bucket since the
seed, but nothing ever derived a latency from it. This module closes the
loop: it synthesizes, from the *same deterministic host counters*
``WaveMeter`` consumes (slot positions, the policy's page budget, the
prefix-cache share bookkeeping), the per-wave DRAM command stream —

* **ACT** — one per activated sector-row, carrying its
  ``act_array_fraction`` tFAW token cost (a 1-sector ACT costs 0.335
  tokens where a full-row ACT costs 1.0);
* **RD** — one burst per fetched 64-byte block with its VBL beat count
  (the fractional newest page is a shortened burst; ``word_fraction``
  halves beats for the fused_q8 int8 cache);
* **WR** — the one-token KV append bursts;
* **PRE** — one per ACT (zero marginal energy: ``e_act_full`` is the
  ACT+PRE *pair*, see ``core/power.py``);
* **REF** — the tREFI-amortized refresh share over the makespan
  (appended by :func:`with_refresh` when background accounting is on)

— and replays it through the ``DDR4Timing`` constants to a modeled
DRAM-limited service time (:attr:`CommandTimeline.dram_ns`).

Command counts are **fluid** (fractional): the newest partial page, the
prefix-cache keep factor, and warm-prefill suffix scaling all produce
fractional aggregates. That is deliberate — it keeps the command ledger's
joules reconcilable with the meter's to ~1e-15 rel (``obs/audit.py``
gates at 1e-9), because the meter's attribution is itself fluid. The
energy *primitives* (``model.act_energy`` / ``rd_energy`` / ``wr_energy``)
are shared with the meter: the double-entry audit checks the
*attribution* arithmetic (caps, rows, partial pages, sharing, layers),
not the calibration constants.

The replay is an analytic (fluid) solution of ``timing.faw_wait``'s
token bucket, not an event loop: starting from the ``faw_burst_acts``
burst allowance, issuing ``faw_tokens`` worth of ACTs takes
``(faw_tokens - burst) / faw_token_rate`` ns, floored by the tRRD
ACT-to-ACT gap; the data bus costs ``max(burst_time(beats), tCK)`` per
burst (a zero-beat fully-masked transfer still occupies one column
command slot); the makespan adds the tRCD+tCL fill and tRP drain only
when rows were opened. Everything is plain host-side ``float`` — no array
math, no wall-clock — so two schedulers producing the same token stream model
bit-identical nanoseconds, the same invariance contract as the joules.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Iterable, Mapping

from repro_torch.core import power
from repro_torch.core.power import FULL_BURST_BEATS
from repro_torch.core.sectors import BLOCK_BYTES, NUM_SECTORS
from repro_torch.core.timing import DDR4Timing, DEFAULT_TIMING, faw_token_rate

__all__ = [
    "DramCommand", "CommandTimeline", "wave_commands", "prefill_commands",
    "replay", "replay_by_slot", "with_refresh", "background_energy",
    "column_slot_ns", "act_issue_span_ns",
]


@dataclasses.dataclass(frozen=True)
class DramCommand:
    """One fluid command aggregate: ``count`` identical commands.

    ``sectors`` is per-ACT enabled sectors, ``beats`` the per-burst DDR
    beat count (RD/WR), ``energy_j`` the aggregate's total joules, and
    ``faw_tokens`` the aggregate's total tFAW power-token draw (ACT only).
    ``slot`` is the serving slot that issued it (-1 for prefill bundles
    and rank-level REF).
    """

    kind: str  # "ACT" | "RD" | "WR" | "PRE" | "REF"
    slot: int
    rid: int
    count: float
    sectors: float = 0.0
    beats: float = 0.0
    energy_j: float = 0.0
    faw_tokens: float = 0.0

    def to_record(self) -> dict[str, Any]:
        return dict(kind=self.kind, slot=self.slot, rid=self.rid,
                    count=self.count, sectors=self.sectors, beats=self.beats,
                    energy_j=self.energy_j, faw_tokens=self.faw_tokens)


@dataclasses.dataclass(frozen=True)
class CommandTimeline:
    """A replayed command stream: spans (ns) + the command-side ledger.

    ``dram_ns`` is the modeled DRAM-limited service time:
    ``lead_ns + max(act_ns, bus_ns) + tail_ns`` — row open/CAS fill,
    then whichever of ACT issue (tFAW/tRRD-limited) or data-bus
    occupancy binds, then the closing precharge.
    """

    commands: tuple[DramCommand, ...]
    dram_ns: float
    act_ns: float  # ACT issue span: token-bucket deficit vs tRRD gaps
    bus_ns: float  # data-bus occupancy (RD + WR bursts, tCK slot floor)
    lead_ns: float  # tRCD + tCL when any row was opened
    tail_ns: float  # tRP when any row was opened
    n_acts: float
    faw_tokens: float
    act_j: float
    rd_j: float
    wr_j: float
    ref_j: float = 0.0

    @property
    def fetch_j(self) -> float:
        return self.act_j + self.rd_j

    @property
    def energy_j(self) -> float:
        return self.act_j + self.rd_j + self.wr_j + self.ref_j

    def ledger(self) -> dict[str, float]:
        """Command-side entries for the double-entry audit."""
        return dict(act_j=self.act_j, rd_j=self.rd_j, wr_j=self.wr_j,
                    ref_j=self.ref_j)

    def to_record(self, **extra: Any) -> dict[str, Any]:
        """JSON-ready form for the flight recorder's command track."""
        rec = dict(dram_ns=self.dram_ns, act_ns=self.act_ns,
                   bus_ns=self.bus_ns, lead_ns=self.lead_ns,
                   tail_ns=self.tail_ns, n_acts=self.n_acts,
                   faw_tokens=self.faw_tokens,
                   commands=[c.to_record() for c in self.commands])
        rec.update(extra)
        return rec


# -- energy/token primitives (shared with the meter, memoized) ---------------
#
# The models are frozen dataclasses (hashable), and the scalar math in
# core/power.py is float32 — calling through these caches keeps command
# synthesis bit-identical to the meter's float() conversions while making
# it nearly free per wave.

@functools.lru_cache(maxsize=1024)
def _act_energy(model: power.DRAMEnergyModel, sectors: float,
                sectored_hw: bool) -> float:
    return float(model.act_energy(sectors, sectored_hw=sectored_hw))


@functools.lru_cache(maxsize=256)
def _rd_energy(model: power.DRAMEnergyModel, beats: float) -> float:
    return float(model.rd_energy(beats))


@functools.lru_cache(maxsize=256)
def _wr_energy(model: power.DRAMEnergyModel, beats: float) -> float:
    return float(model.wr_energy(beats))


@functools.lru_cache(maxsize=1024)
def _faw_cost(sectors: float) -> float:
    return float(power.act_array_fraction(sectors))


# -- command synthesis -------------------------------------------------------

def _fetch_commands(geometry, *, slot: int, rid: int, pages_fetched: float,
                    pages_valid: float, word_fraction: float,
                    sectored_hw: bool, scale: float,
                    model: power.DRAMEnergyModel) -> list[DramCommand]:
    """ACT/RD/PRE aggregates for one slot's KV read pass.

    Mirrors ``power.kv_fetch_energy``'s attribution exactly (ceils, the
    rows/sectors cap, the fractional newest page, the coarse-grained
    full-row branch) but builds commands instead of a joule total —
    the independent second entry of the audit. ``scale`` folds in
    ``n_layers`` and the prefix-share keep factor (or the warm-prefill
    suffix fraction): every layer replays the same per-layer commands.
    """
    if pages_valid <= 0:
        return []
    valid_sectors = int(math.ceil(pages_valid))
    rows_valid = (valid_sectors + NUM_SECTORS - 1) // NUM_SECTORS
    blocks_per_page = geometry.page_kv_bytes / BLOCK_BYTES
    rd_beats = FULL_BURST_BEATS * float(word_fraction)
    if not sectored_hw:
        # coarse-grained baseline: full-row ACTs, every valid page moved
        acts = rows_valid
        sectors_per_act = float(NUM_SECTORS)
        moved = float(pages_valid)
        act_e = _act_energy(model, float(NUM_SECTORS), False)
    else:
        fetched_sectors = min(int(math.ceil(pages_fetched)), valid_sectors)
        if fetched_sectors <= 0:
            return []
        acts = min(rows_valid, fetched_sectors)
        sectors_per_act = fetched_sectors / acts
        moved = min(float(pages_fetched), float(pages_valid))
        act_e = _act_energy(model, sectors_per_act, True)
    n_act = scale * acts
    cmds = [DramCommand("ACT", slot, rid, count=n_act,
                        sectors=sectors_per_act,
                        energy_j=scale * acts * act_e,
                        faw_tokens=scale * acts * _faw_cost(sectors_per_act))]
    rd_count = scale * moved * blocks_per_page
    if rd_count > 0:
        cmds.append(DramCommand(
            "RD", slot, rid, count=rd_count, beats=rd_beats,
            energy_j=scale * moved * blocks_per_page
            * _rd_energy(model, rd_beats)))
    # e_act_full is the ACT+PRE pair energy, so PRE carries zero marginal
    # joules — it exists for the timeline (the tRP drain) and the track
    cmds.append(DramCommand("PRE", slot, rid, count=n_act))
    return cmds


def _append_commands(geometry, *, slot: int, rid: int, tokens: float,
                     scale: float,
                     model: power.DRAMEnergyModel) -> list[DramCommand]:
    """Full-width WR bursts for ``tokens`` one-token KV appends."""
    blocks = tokens * geometry.token_kv_bytes / BLOCK_BYTES
    if blocks <= 0:
        return []
    return [DramCommand(
        "WR", slot, rid, count=scale * blocks, beats=float(FULL_BURST_BEATS),
        energy_j=scale * blocks * _wr_energy(model, float(FULL_BURST_BEATS)))]


def wave_commands(geometry, *, sectored: bool, k_pages: int | None,
                  slots: list[tuple[int, int, int]],
                  shared_groups: list[Mapping[str, Any]] | None = None,
                  sectored_hw: bool = True,
                  model: power.DRAMEnergyModel = power.DEFAULT_ENERGY
                  ) -> list[DramCommand]:
    """The command stream for one decode wave.

    Takes the identical inputs ``WaveMeter.record_wave`` takes —
    ``slots`` is ``[(slot, rid, position), ...]``, ``shared_groups`` the
    prefix-cache co-reader bookkeeping — and re-derives per-slot fetch
    width, the fractional newest page, and the proportional shared-fetch
    keep factor from scratch. The meter never feeds this function its own
    joules; that independence is what makes the audit double-entry.
    """
    g = geometry
    share_of: dict[int, tuple[int, float]] = {}
    for grp in shared_groups or []:
        members = list(grp["slots"])
        if len(members) < 2:
            continue
        units = float(grp["shared_tokens"]) / g.page_size
        if units <= 0:
            continue
        for s in members:
            share_of[int(s)] = (len(members), units)
    cmds: list[DramCommand] = []
    for slot, rid, position in slots:
        valid_pages = min(position // g.page_size + 1, g.total_pages)
        partial = (position % g.page_size + 1) / g.page_size
        valid_units = (valid_pages - 1) + partial
        if sectored and k_pages is not None and sectored_hw:
            k_slot = min(int(k_pages), valid_pages)
            fetched_units = (k_slot - 1) + partial
            word_fraction = g.kv_word_fraction
        else:
            fetched_units = valid_units
            word_fraction = 1.0
        keep = 1.0
        if slot in share_of and fetched_units > 0:
            n_readers, shared_units = share_of[slot]
            share_frac = min(shared_units, fetched_units) / fetched_units
            keep = 1.0 - share_frac * (1.0 - 1.0 / n_readers)
        cmds.extend(_fetch_commands(
            g, slot=slot, rid=rid, pages_fetched=fetched_units,
            pages_valid=valid_units, word_fraction=word_fraction,
            sectored_hw=sectored_hw, scale=g.n_layers * keep, model=model))
        cmds.extend(_append_commands(g, slot=slot, rid=rid, tokens=1.0,
                                     scale=float(g.n_layers), model=model))
    return cmds


def prefill_commands(geometry, *, prompt_len: int, cached_tokens: int = 0,
                     rid: int = -1, sectored_hw: bool = True,
                     model: power.DRAMEnergyModel = power.DEFAULT_ENERGY
                     ) -> list[DramCommand]:
    """The command stream for one request's prefill.

    S-token full-width appends plus ONE exact-mode read pass over the
    final cache, scaled by the warm-admission suffix fraction — the same
    single-pass model ``WaveMeter.record_prefill`` charges. A warm
    prefix hit therefore shortens the modeled timeline too: the paper's
    latency win compounds with the prefix cache's energy win.
    """
    g = geometry
    cached = min(max(int(cached_tokens), 0), prompt_len)
    suffix_frac = (prompt_len - cached) / prompt_len if prompt_len else 1.0
    valid_units = prompt_len / g.page_size
    cmds = _fetch_commands(
        g, slot=-1, rid=rid, pages_fetched=valid_units,
        pages_valid=valid_units, word_fraction=1.0, sectored_hw=sectored_hw,
        scale=g.n_layers * suffix_frac, model=model)
    cmds.extend(_append_commands(
        g, slot=-1, rid=rid, tokens=float(prompt_len - cached),
        scale=float(g.n_layers), model=model))
    return cmds


# -- replay ------------------------------------------------------------------

def column_slot_ns(beats: float, timing: DDR4Timing = DEFAULT_TIMING) -> float:
    """Data-bus/command-slot occupancy of one burst: ``burst_time(beats)``
    floored at one column command slot (tCK) — a zero-beat fully-masked
    VBL transfer still issues its RD, it just drives no data beats."""
    return max(float(beats) * timing.tCK / 2.0, timing.tCK)


def act_issue_span_ns(n_acts: float, faw_tokens: float,
                      timing: DDR4Timing = DEFAULT_TIMING) -> float:
    """First-to-last ACT issue time: the fluid closed form of
    ``timing.faw_wait``. The bucket starts with the ``faw_burst_acts``
    burst allowance and refills at ``faw_token_rate``; the span is the
    token deficit over that rate, floored by the tRRD ACT-to-ACT gap.
    Fewer tokens per sectored ACT ⇒ shorter span — the paper's §4.1
    performance mechanism, as nanoseconds."""
    if n_acts <= 0:
        return 0.0
    deficit = max(faw_tokens - timing.faw_burst_acts, 0.0)
    gaps = max(n_acts - 1.0, 0.0) * timing.tRRD
    return max(deficit / faw_token_rate(timing), gaps)


def replay(commands: Iterable[DramCommand],
           timing: DDR4Timing = DEFAULT_TIMING) -> CommandTimeline:
    """Replay a command stream to its modeled DRAM-limited makespan.

    ``dram_ns = lead + max(act_ns, bus_ns) + tail``: the pipelined row
    open + CAS fill (tRCD + tCL, paid once — waves stream their fetches),
    then the binding resource — ACT issue under the tFAW token bucket
    (tRRD-floored) or data-bus occupancy — then the closing PRE (tRP).
    An ACT-free stream (pure appends/masked transfers) costs bus time
    only; an empty stream costs 0.
    """
    cmds = tuple(commands)
    n_acts = faw = 0.0
    act_j = rd_j = wr_j = ref_j = 0.0
    bus_ns = 0.0
    for c in cmds:
        if c.kind == "ACT":
            n_acts += c.count
            faw += c.faw_tokens
            act_j += c.energy_j
        elif c.kind == "RD":
            bus_ns += c.count * column_slot_ns(c.beats, timing)
            rd_j += c.energy_j
        elif c.kind == "WR":
            bus_ns += c.count * column_slot_ns(c.beats, timing)
            wr_j += c.energy_j
        elif c.kind == "REF":
            ref_j += c.energy_j
    act_ns = act_issue_span_ns(n_acts, faw, timing)
    lead_ns = (timing.tRCD + timing.tCL) if n_acts > 0 else 0.0
    tail_ns = timing.tRP if n_acts > 0 else 0.0
    if n_acts > 0 or bus_ns > 0:
        dram_ns = lead_ns + max(act_ns, bus_ns) + tail_ns
    else:
        dram_ns = 0.0
    return CommandTimeline(commands=cmds, dram_ns=dram_ns, act_ns=act_ns,
                           bus_ns=bus_ns, lead_ns=lead_ns, tail_ns=tail_ns,
                           n_acts=n_acts, faw_tokens=faw, act_j=act_j,
                           rd_j=rd_j, wr_j=wr_j, ref_j=ref_j)


def replay_by_slot(commands: Iterable[DramCommand],
                   timing: DDR4Timing = DEFAULT_TIMING
                   ) -> dict[int, CommandTimeline]:
    """Each slot's own sub-stream replayed alone (per-request background
    attribution shares the wave's one window proportionally to these)."""
    groups: dict[int, list[DramCommand]] = {}
    for c in commands:
        groups.setdefault(c.slot, []).append(c)
    return {slot: replay(cs, timing) for slot, cs in sorted(groups.items())}


def with_refresh(timeline: CommandTimeline, *,
                 model: power.DRAMEnergyModel = power.DEFAULT_ENERGY
                 ) -> CommandTimeline:
    """Append the tREFI-amortized REF share for this makespan.

    ``count`` is the fluid number of refresh commands the window overlaps
    (``dram_ns / tREFI``); the energy is ``p_refresh`` over the window —
    the same average-power amortization the meter charges, so the audit
    entry is exact by construction (both sides share the one timing
    model; REF is a derived entry, not an independent one)."""
    if timeline.dram_ns <= 0:
        return timeline
    t = model.timing
    ref_j = model.p_refresh * (timeline.dram_ns * 1e-9)
    ref = DramCommand("REF", -1, -1, count=timeline.dram_ns / t.tREFI,
                      energy_j=ref_j)
    return dataclasses.replace(timeline, commands=timeline.commands + (ref,),
                               ref_j=timeline.ref_j + ref_j)


def background_energy(timeline: CommandTimeline, *,
                      model: power.DRAMEnergyModel = power.DEFAULT_ENERGY
                      ) -> float:
    """Active-standby joules over the timeline's makespan (IDD3N-class
    ``p_background_active``), the command-side entry for ``bg_j``."""
    return model.p_background_active * (timeline.dram_ns * 1e-9)
