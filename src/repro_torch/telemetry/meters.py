"""WaveMeter: per-wave DRAM energy accounting for the serving stack
(counterpart of the JAX package's ``telemetry/meters.py``).

Maps the serving runtime's KV traffic onto the paper's calibrated power
model (``core/power.py``, Fig. 9 anchors): KV *pages* play the paper's
*sectors*, a row holds ``NUM_SECTORS`` consecutive pages, and each decode
wave is charged

* **ACT** — one sectored row activation per touched row, enabling only the
  fetched sectors (``power.kv_fetch_energy``: the fixed periphery share is
  paid per activation, the per-sector array share scales — the 12.7% vs
  66.5% split of Fig. 9);
* **RD** — full-burst block reads for the pages actually moved (the
  channel-byte reduction of Fig. 14; the newest page moves only its
  written fraction — the VBL shortened burst);
* **WR** — the one-token KV append, identical on every path;
* optionally (``background=True``, off by default) **modeled
  background/refresh** — active-standby plus tREFI-amortized refresh
  power charged over a modeled busy window (row cycles + bus bursts
  from ``core/timing.py``) derived from the same counters, never from
  wall-clock.

Everything is computed from *host-side counters* (slot positions the
session already tracks, the policy's requested page budget) — never from
wall-clock or device timings — so two schedulers that produce the same
token stream report bit-identical joules. Wall-clock is recorded per wave
for throughput reporting but is deliberately excluded from energy.

Every metered wave/prefill is additionally synthesized into a DRAM
command timeline (``repro_torch.obs.commands``) from the same counters and
replayed through the DDR4 timing model: ``dram_ns`` on wave records and
per-request stats is the modeled DRAM-limited service time (the paper's
tFAW-relaxation performance side), and the command ledger's joules are
reconciled against this meter's every wave — the double-entry energy
audit (``repro_torch.obs.audit``, on by default; ``audit=False`` opts out).
The modeled background busy window is the timeline's *makespan* (ACT
issue legally overlapped under the tFAW token bucket / tRRD), not a
serialized ``acts * tRC`` sum.

Metering attaches via :class:`MeteredBackend`, a decorator over any
``DecodeBackend``. The session discovers the meter through the backend's
``meter`` attribute; a plain backend has none and the metering branches
cost one ``is None`` check per step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping

import numpy as np

from repro_torch.core import power
from repro_torch.obs import audit as energy_audit
from repro_torch.obs import commands as dram_commands
from repro_torch.telemetry.recorder import TraceRecorder


@dataclasses.dataclass(frozen=True)
class KVGeometry:
    """Static KV-cache layout the meter converts counters with.

    ``page_kv_bytes`` is the K+V footprint of ONE page in ONE layer across
    all kv heads — per-wave traffic scales by ``n_layers`` because every
    layer re-fetches its own cache.

    ``kv_word_fraction`` is the bytes-per-word term of sectored decode
    fetches (``power.kv_fetch_energy``): 1.0 for the bf16 cache, 0.5 when
    the backend's fused kernel reads per-sector int8 KV
    (``kernels/quantized_kv.py``). It applies ONLY to sectored decode
    reads — prefill, dense/exact waves and the one-token append all move
    the full-width master cache.
    """

    page_size: int  # tokens per KV page (one sector)
    total_pages: int  # page capacity of the padded cache
    page_kv_bytes: float  # K+V bytes per page per layer (all kv heads)
    n_layers: int
    kv_word_fraction: float = 1.0

    @property
    def token_kv_bytes(self) -> float:
        """K+V bytes one token appends per layer."""
        return self.page_kv_bytes / self.page_size

    @classmethod
    def from_model_cfg(cls, cfg, *, seq_len: int, page_size: int,
                       kv_dtype_bytes: int = 2,
                       total_pages: int | None = None,
                       kv_word_fraction: float = 1.0) -> "KVGeometry":
        """Geometry for a model config (bf16 KV cache by default).

        ``total_pages`` overrides the plain ``ceil(seq_len / page_size)``
        for backends with a padded page capacity (SectoredKVBackend passes
        its own) — the K+V byte formula stays in this one place.
        """
        page_kv_bytes = (page_size * cfg.n_kv_heads * cfg.head_dim_
                         * 2 * kv_dtype_bytes)
        if total_pages is None:
            total_pages = max(math.ceil(seq_len / page_size), 1)
        return cls(page_size=page_size, total_pages=total_pages,
                   page_kv_bytes=float(page_kv_bytes),
                   n_layers=cfg.n_layers,
                   kv_word_fraction=kv_word_fraction)


def attn_mass_captured(table: np.ndarray, position: int, page_size: int,
                       k: int) -> float:
    """Predictor-side estimate of the attention mass the top-k covers.

    ``table`` is one slot's sector-history table ``(L, Hkv, P)`` (EMA of
    observed per-page attention mass). The selection mirrors
    ``sector_predictor.predict_topk``: the newest page always wins a slot
    (recency bonus), the remaining ``k - 1`` go to the highest scores.

    This is the predictor's *own* estimate, biased high under a narrow
    selection — like the paper's SHT, the table only observes mass on the
    sectors that were fetched, so unfetched pages decay regardless of their
    true usefulness. Honest immediately after an exact-mode (all-pages)
    phase such as prefill; treat long-sectored-run values as an upper
    bound.
    """
    L, H, P = table.shape
    cur = min(position // page_size, P - 1)
    n_valid = cur + 1
    k = min(int(k), n_valid)
    if k >= n_valid:
        return 1.0
    valid = table[..., :n_valid].astype(np.float64)  # (L, H, n_valid)
    total = valid.sum(axis=-1)
    captured = valid[..., cur].copy()
    if k > 1:
        others = np.delete(valid, cur, axis=-1)
        others = np.sort(others, axis=-1)[..., ::-1]
        captured += others[..., :k - 1].sum(axis=-1)
    share = np.where(total > 1e-12, captured / np.maximum(total, 1e-12), 1.0)
    return float(np.mean(share))


def _zero_totals() -> dict[str, float]:
    return dict(waves=0, sectored_waves=0, dense_waves=0, tokens=0,
                prefill_events=0, prefill_tokens=0, overlapped_prefills=0,
                resumed_prefills=0, evictions=0, evicted_pages=0.0,
                pages_fetched=0.0, pages_valid=0.0, acts=0, sectors=0.0,
                act_j=0.0, rd_j=0.0, wr_j=0.0, prefill_j=0.0, wall_s=0.0,
                bg_j=0.0, ref_j=0.0, busy_ns=0.0, demand_merges=0,
                # modeled DRAM-limited service time (ns) from the command
                # timeline replay: decode waves and prefill passes
                # separately, plus the double-entry audit's books —
                # reconciliations run and the worst relative error seen
                dram_ns=0.0, prefill_dram_ns=0.0,
                audit_checks=0, audit_max_rel_err=0.0,
                # decode-fetch byte books: bytes actually moved by sectored
                # decode reads, and the bytes per-sector int8 quantization
                # shaved off them (kv_word_fraction < 1) — both derived
                # from the same host counters as the joules
                fetched_bytes=0.0, quant_saved_bytes=0.0,
                # prefix-cache attribution (serve.prefix): prompt tokens
                # whose KV a warm admission reused instead of re-prefilling,
                # and the decode ACT/RD joules amortized away across
                # co-resident readers of a shared prefix
                prefix_hit_tokens=0, shared_act_j=0.0, shared_rd_j=0.0)


class WaveMeter:
    """Accumulates per-wave counters and converts them to joules.

    ``record_wave`` / ``record_prefill`` are driven by ``ServeSession``;
    per-request attribution lands in :attr:`per_request` and surfaces
    through ``StreamHandle.telemetry`` / ``StreamHandle.energy_j``.
    """

    def __init__(self, geometry: KVGeometry, *,
                 recorder: TraceRecorder | None = None,
                 energy_model: power.DRAMEnergyModel | None = None,
                 sectored_hw: bool = True,
                 mesh_shape: tuple[int, ...] | None = None,
                 background: bool = False, audit: bool = True):
        if geometry is None:
            raise ValueError(
                "WaveMeter needs a KVGeometry: pass one explicitly or meter "
                "a backend exposing kv_geometry() (SectoredKVBackend does)")
        self.geometry = geometry
        # modeled background + refresh energy (ROADMAP follow-up): charge
        # standby/refresh power over a *modeled* DRAM busy time derived
        # from the same deterministic counters as everything else (row
        # cycles + bus bursts from core/timing.py — NEVER wall-clock, so
        # fifo/overlap and every mesh shape still report bit-identical
        # joules for identical token streams). Off by default: it adds a
        # workload-independent floor that dilutes the ACT/RD orderings
        # the paper's claims are about.
        self.background = background
        # provenance only: a mesh backend (not ported yet) stamps the mesh
        # it executes waves on. Energy NEVER depends on it — counters are
        # host-side.
        self.mesh_shape = mesh_shape
        self.recorder = recorder if recorder is not None else TraceRecorder()
        self.model = energy_model if energy_model is not None else power.DEFAULT_ENERGY
        # deployment property: False models the coarse-grained DRAM baseline
        # (full-row ACTs, every valid page moved, no sector-logic overhead)
        self.sectored_hw = sectored_hw
        # double-entry audit: every wave/prefill's command-ledger joules
        # must reconcile with this meter's (repro_torch.obs.audit). On by
        # default — the check is pure host float math and a divergence is
        # always a bug worth failing loudly on.
        self.audit = audit
        # the most recent replayed command timelines, for the flight
        # recorder's command track (ServeSession hands them to
        # FlightRecorder.on_wave) and for tests
        self.last_timeline: dram_commands.CommandTimeline | None = None
        self.last_prefill_timeline: dram_commands.CommandTimeline | None = None
        # latest prefill timeline per rid (a resume overwrites): the
        # flight recorder reads these at admit time for the prefill
        # command records — group prefills admit after several
        # record_prefill calls, so "last" alone would misattribute
        self.prefill_timelines: dict[int, dram_commands.CommandTimeline] = {}
        self.totals = _zero_totals()
        self.per_request: dict[int, dict[str, float]] = {}

    # -- per-request attribution ------------------------------------------

    def _req(self, rid: int) -> dict[str, float]:
        return self.per_request.setdefault(
            rid, dict(energy_j=0.0, tokens=0, prefill_tokens=0,
                      pages_fetched=0.0, pages_valid=0.0, evictions=0,
                      dram_ns=0.0, prefill_dram_ns=0.0))

    def request_stats(self, rid: int) -> dict[str, float] | None:
        stats = self.per_request.get(rid)
        return None if stats is None else dict(stats)

    # -- background / refresh (modeled, deterministic) ---------------------

    def _background_charge(self, timeline: dram_commands.CommandTimeline
                           ) -> tuple[float, float, float]:
        """(busy_ns, bg_j, ref_j) for one access bundle's timeline.

        The busy window is the command timeline's *makespan*
        (``CommandTimeline.dram_ns``): ACT issue legally overlapped under
        the tFAW token bucket with its tRRD floor, data-bus bursts, the
        one pipelined row-open/precharge overhead. (The previous model
        summed ``acts * tRC`` serially, overstating the window by the
        overlap the token bucket permits — exactly the latency slack the
        paper's §4.1 mechanism exploits.) Still a *model* from host-side
        counters, never a measurement, so the charge stays scheduler- and
        mesh-invariant. Standby power is ``IDD3N``-class active
        background (``p_background_active``); refresh is the
        tREFI-amortized average (``p_refresh``), both over this window.
        """
        busy_ns = timeline.dram_ns
        busy_s = busy_ns * 1e-9
        return (busy_ns, self.model.p_background_active * busy_s,
                self.model.p_refresh * busy_s)

    # -- double-entry audit ------------------------------------------------

    def _run_audit(self, meter_side: dict[str, float],
                   command_side: dict[str, float], *, where: str) -> None:
        """Reconcile this meter's entry against the command ledger's
        (raises ``repro_torch.obs.audit.AuditError`` on divergence) and keep
        the running worst-case books for reports/metrics."""
        ledger = energy_audit.reconcile(meter_side, command_side,
                                        where=where)
        self.totals["audit_checks"] += 1
        self.totals["audit_max_rel_err"] = max(
            self.totals["audit_max_rel_err"],
            energy_audit.max_rel_err(ledger))

    # -- recording hooks ---------------------------------------------------

    def record_prefill(self, rid: int, prompt_len: int, *,
                       overlapped: bool = False,
                       resumed: bool = False,
                       cached_tokens: int = 0) -> None:
        """One request's prefill: S token appends + ONE exact-mode read
        pass over the final cache (prefill is single-pass in a production
        backend; our per-token reference loop is an implementation detail
        the energy model must not charge quadratically).

        ``resumed=True`` marks a post-preemption re-prefill (over
        ``prompt + generated``): its joules are charged in full — the
        energy cost of an eviction IS the re-prefill that undoes it — and
        the token it emits is a genuinely new one (the scan's final
        logits predict position ``len(generated)``), so the ``tokens``
        counters advance exactly as the uncontended run's would.

        ``cached_tokens > 0`` marks a prefix-cache warm admission: the
        first ``cached_tokens`` of the prompt were seeded from a shared
        entry, so only the suffix is appended and the read pass scales
        proportionally (the matched prefix's ACT/RD was paid once, by
        the request that inserted the entry). ``prefill_tokens`` keeps
        full-prompt semantics — the reuse shows up in the separate
        ``prefix_hit_tokens`` counter and in joules, never in the
        token books the stream oracles audit.
        """
        g = self.geometry
        cached = min(max(int(cached_tokens), 0), prompt_len)
        suffix_frac = (prompt_len - cached) / prompt_len if prompt_len else 1.0
        valid_units = prompt_len / g.page_size
        fetch = power.kv_fetch_energy(valid_units, valid_units,
                                      page_bytes=g.page_kv_bytes,
                                      sectored_hw=self.sectored_hw,
                                      model=self.model)
        joules = g.n_layers * (
            suffix_frac * (fetch["act_j"] + fetch["rd_j"])
            + (prompt_len - cached) * power.kv_append_energy(
                g.token_kv_bytes, model=self.model))
        # second entry: the same prefill synthesized as a command stream
        # (independent attribution arithmetic) and replayed to a modeled
        # service time — warm admissions shorten the timeline too
        tl = dram_commands.replay(dram_commands.prefill_commands(
            g, prompt_len=prompt_len, cached_tokens=cached, rid=rid,
            sectored_hw=self.sectored_hw, model=self.model),
            self.model.timing)
        if self.background:
            tl = dram_commands.with_refresh(tl, model=self.model)
        self.last_prefill_timeline = tl
        self.prefill_timelines[rid] = tl
        self.totals["prefill_dram_ns"] += tl.dram_ns
        self.totals["prefill_events"] += 1
        self.totals["prefill_tokens"] += prompt_len
        self.totals["prefix_hit_tokens"] += cached
        self.totals["prefill_j"] += joules
        self.totals["tokens"] += 1  # the prefill-emitted first token
        if overlapped:
            self.totals["overlapped_prefills"] += 1
        if resumed:
            self.totals["resumed_prefills"] += 1
        req = self._req(rid)
        req["energy_j"] += joules
        req["prefill_tokens"] += prompt_len
        req["tokens"] += 1
        req["dram_ns"] += tl.dram_ns
        req["prefill_dram_ns"] += tl.dram_ns
        bg_j = ref_j = 0.0
        if self.background:
            busy_ns, bg_j, ref_j = self._background_charge(tl)
            self.totals["busy_ns"] += busy_ns
            self.totals["bg_j"] += bg_j
            self.totals["ref_j"] += ref_j
            req["energy_j"] += bg_j + ref_j
        if self.audit:
            meter_side = dict(prefill_j=joules)
            command_side = dict(prefill_j=tl.act_j + tl.rd_j + tl.wr_j)
            if self.background:
                meter_side.update(bg_j=bg_j, ref_j=ref_j)
                command_side.update(
                    bg_j=dram_commands.background_energy(tl,
                                                         model=self.model),
                    ref_j=tl.ref_j)
            self._run_audit(meter_side, command_side,
                            where=f"prefill rid={rid}")

    def record_eviction(self, rid: int, *, kv_tokens: int,
                        kv_pages: int) -> None:
        """One KV-page preemption: ``kv_pages`` pages covering
        ``kv_tokens`` cached tokens dropped from the pool. Freeing DRAM
        costs no energy — the charge for an eviction is the *resumed*
        re-prefill that later rebuilds the cache (``record_prefill`` with
        ``resumed=True``); this hook only counts the event so reports can
        tie re-prefill joules to the preemptions that caused them."""
        self.totals["evictions"] += 1
        self.totals["evicted_pages"] += float(kv_pages)
        self._req(rid)["evictions"] += 1

    def record_wave(self, *, sectored: bool, k_pages: int | None,
                    slots: list[tuple[int, int, int]], wall_s: float = 0.0,
                    state_views: Mapping[int, tuple] | None = None,
                    shared_groups: list[Mapping[str, Any]] | None = None
                    ) -> None:
        """One decode wave.

        ``slots`` is ``[(slot, rid, position), ...]`` for the active slots,
        with ``position`` the cache length at attend time (tracked
        host-side by the session — no device read). ``state_views``
        optionally maps slot -> ``(table, position)`` numpy views for the
        attention-mass estimate.

        ``shared_groups`` is the prefix-cache shared-fetch attribution
        input: ``[{"slots": [...], "shared_tokens": int}, ...]`` — each
        group the co-resident readers of one shared prefix entry, with
        ``shared_tokens`` the smallest member's complete-page share. The
        policy is **proportional amortization**: one physical fetch of
        the shared span serves all ``n`` readers, so each member's ACT
        and RD (and ``pages_fetched``) scale by ``1 - f*(1 - 1/n)`` where
        ``f`` is the shared span's fraction of the member's own fetch.
        Proportional — not sub-fetch decomposition — because the row/ACT
        accounting in ``kv_fetch_energy`` ceils, and splitting a fetch in
        two can *raise* its modeled cost; scaling guarantees nonnegative
        savings and strict monotonicity in both ``f`` and ``n``. Savings
        accumulate in ``shared_act_j``/``shared_rd_j``. Derived from
        host-side lease bookkeeping like every other counter, so the
        scheduler/mesh joule identities extend to shared fetches.
        """
        g = self.geometry
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
        wave = dict(act_j=0.0, rd_j=0.0, wr_j=0.0, fetched=0.0, valid=0.0,
                    acts=0, sectors=0.0, bg_j=0.0, ref_j=0.0, busy_ns=0.0,
                    fetched_bytes=0.0, quant_saved_bytes=0.0)
        masses = []
        for slot, rid, position in slots:
            valid_pages = min(position // g.page_size + 1, g.total_pages)
            partial = (position % g.page_size + 1) / g.page_size
            valid_units = (valid_pages - 1) + partial
            if sectored and k_pages is not None and self.sectored_hw:
                k_slot = min(int(k_pages), valid_pages)
                # the newest (partial) page is always selected (recency
                # bonus), so it contributes its written fraction only
                fetched_units = (k_slot - 1) + partial
                # only genuinely sectored fetches go through the fused
                # kernel's quantized pages; dense/exact waves read the
                # full-width bf16 master cache
                word_fraction = g.kv_word_fraction
            else:
                # dense wave — or coarse-grained hardware, which moves
                # every valid page no matter what the policy asked for
                k_slot = valid_pages
                fetched_units = valid_units
                word_fraction = 1.0
            fetch = power.kv_fetch_energy(fetched_units, valid_units,
                                          page_bytes=g.page_kv_bytes,
                                          sectored_hw=self.sectored_hw,
                                          word_fraction=word_fraction,
                                          model=self.model)
            act_j = g.n_layers * fetch["act_j"]
            rd_j = g.n_layers * fetch["rd_j"]
            wr_j = g.n_layers * power.kv_append_energy(g.token_kv_bytes,
                                                       model=self.model)
            if slot in share_of and fetched_units > 0:
                n_readers, shared_units = share_of[slot]
                share_frac = min(shared_units, fetched_units) / fetched_units
                keep = 1.0 - share_frac * (1.0 - 1.0 / n_readers)
                self.totals["shared_act_j"] += act_j * (1.0 - keep)
                self.totals["shared_rd_j"] += rd_j * (1.0 - keep)
                act_j *= keep
                rd_j *= keep
                fetched_units *= keep
            wave["act_j"] += act_j
            wave["rd_j"] += rd_j
            wave["wr_j"] += wr_j
            wave["fetched"] += fetched_units
            wave["valid"] += valid_units
            wave["acts"] += g.n_layers * fetch["acts"]
            wave["sectors"] += g.n_layers * fetch["sectors"]
            full_bytes = g.n_layers * fetched_units * g.page_kv_bytes
            wave["fetched_bytes"] += full_bytes * word_fraction
            wave["quant_saved_bytes"] += full_bytes * (1.0 - word_fraction)
            req = self._req(rid)
            req["energy_j"] += act_j + rd_j + wr_j
            req["tokens"] += 1
            req["pages_fetched"] += fetched_units
            req["pages_valid"] += valid_units
            if (sectored and k_pages is not None and state_views is not None
                    and slot in state_views):
                table, _ = state_views[slot]
                table = np.asarray(table)
                if table.ndim == 4:  # (L, B=1, Hkv, P) -> (L, Hkv, P)
                    table = table[:, 0]
                if table.ndim == 3 and table.shape[-1] >= 1:
                    masses.append(attn_mass_captured(
                        table, position, g.page_size, k_pages))

        # second entry: the whole wave synthesized as one command stream
        # (independent re-derivation of fetch widths, caps, and the
        # shared-fetch keep factor) and replayed through the DDR4 timing
        # model — the wave's modeled DRAM-limited service time
        cmds = dram_commands.wave_commands(
            g, sectored=sectored, k_pages=k_pages, slots=slots,
            shared_groups=shared_groups, sectored_hw=self.sectored_hw,
            model=self.model)
        tl = dram_commands.replay(cmds, self.model.timing)
        if self.background:
            # one rank, one window: the wave's makespan is the busy span,
            # charged once and split across residents in proportion to
            # each slot's own sub-stream makespan (deterministic, sums
            # exactly to the wave total)
            slot_spans = {
                s: sub.dram_ns for s, sub in
                dram_commands.replay_by_slot(cmds, self.model.timing).items()}
            total_span = sum(slot_spans.values())
            tl = dram_commands.with_refresh(tl, model=self.model)
            busy_ns, bg_j, ref_j = self._background_charge(tl)
            wave["busy_ns"] = busy_ns
            wave["bg_j"] = bg_j
            wave["ref_j"] = ref_j
            for slot, rid, _position in slots:
                frac = (slot_spans.get(slot, 0.0) / total_span
                        if total_span > 0 else 1.0 / len(slots))
                self._req(rid)["energy_j"] += (bg_j + ref_j) * frac
        self.last_timeline = tl
        for _slot, rid, _position in slots:
            # latency is experienced, not divided: every resident request
            # waits out the whole wave's DRAM service window
            self._req(rid)["dram_ns"] += tl.dram_ns
        if self.audit:
            meter_side = dict(act_j=wave["act_j"], rd_j=wave["rd_j"],
                              wr_j=wave["wr_j"])
            command_side = dict(act_j=tl.act_j, rd_j=tl.rd_j, wr_j=tl.wr_j)
            if self.background:
                meter_side.update(bg_j=wave["bg_j"], ref_j=wave["ref_j"])
                command_side.update(
                    bg_j=dram_commands.background_energy(tl,
                                                         model=self.model),
                    ref_j=tl.ref_j)
            self._run_audit(meter_side, command_side,
                            where=f"wave {self.totals['waves']}")

        t = self.totals
        t["waves"] += 1
        t["sectored_waves" if sectored else "dense_waves"] += 1
        t["tokens"] += len(slots)
        t["pages_fetched"] += wave["fetched"]
        t["pages_valid"] += wave["valid"]
        t["acts"] += wave["acts"]
        t["sectors"] += wave["sectors"]
        t["act_j"] += wave["act_j"]
        t["rd_j"] += wave["rd_j"]
        t["wr_j"] += wave["wr_j"]
        t["bg_j"] += wave["bg_j"]
        t["ref_j"] += wave["ref_j"]
        t["busy_ns"] += wave["busy_ns"]
        t["dram_ns"] += tl.dram_ns
        t["fetched_bytes"] += wave["fetched_bytes"]
        t["quant_saved_bytes"] += wave["quant_saved_bytes"]
        t["wall_s"] += wall_s

        record = dict(
            path="sectored" if sectored else "dense",
            k_pages=k_pages if sectored else None,
            slots=len(slots), tokens=len(slots),
            pages_fetched=round(wave["fetched"], 6),
            pages_valid=round(wave["valid"], 6),
            acts=wave["acts"],
            act_j=wave["act_j"], rd_j=wave["rd_j"], wr_j=wave["wr_j"],
            energy_j=wave["act_j"] + wave["rd_j"] + wave["wr_j"],
            dram_ns=tl.dram_ns,
            wall_s=wall_s,
            sector_coverage=(wave["fetched"] / wave["valid"]
                             if wave["valid"] > 0 else 1.0),
        )
        if self.background:
            record["bg_j"] = wave["bg_j"]
            record["ref_j"] = wave["ref_j"]
            record["busy_ns"] = wave["busy_ns"]
        if masses:
            record["attn_mass"] = float(np.mean(masses))
        self.recorder.append(record)

    # -- aggregate views ---------------------------------------------------

    @property
    def decode_j(self) -> float:
        """Deterministic decode-path DRAM energy (ACT + RD + WR)."""
        t = self.totals
        return t["act_j"] + t["rd_j"] + t["wr_j"]

    @property
    def background_j(self) -> float:
        """Modeled standby + refresh energy (0.0 unless ``background``)."""
        return self.totals["bg_j"] + self.totals["ref_j"]

    @property
    def energy_j(self) -> float:
        """Total deterministic DRAM energy including prefill (and the
        modeled background/refresh component when enabled)."""
        return self.decode_j + self.totals["prefill_j"] + self.background_j

    def report(self) -> dict[str, Any]:
        """Flat summary for end-of-run tables and BENCH_*.json payloads."""
        t = dict(self.totals)
        fetched, valid = t["pages_fetched"], t["pages_valid"]
        return dict(
            **t,
            decode_j=self.decode_j,
            energy_j=self.energy_j,
            sector_coverage=fetched / valid if valid > 0 else 1.0,
            ema=dict(self.recorder.ema),
            mesh_shape=(list(self.mesh_shape)
                        if self.mesh_shape is not None else None),
        )


class MeteredBackend:
    """Opt-in metering decorator over any ``DecodeBackend``.

    Delegates every data-path callable *by identity* — the session's wave
    cache keys on ``id(fn)``, and a captured CUDA graph runs a Python
    wrapper's side effects exactly once, at capture, so the replayed
    callables cannot carry counters. All metering therefore happens on the
    host control plane: the session discovers the meter via this object's
    ``meter`` attribute and drives ``record_prefill`` / ``record_wave``
    around each wave, and ``merge_demands`` (a per-wave Python call) is
    counted here. Wrapping costs nothing when unused: a session over a
    plain backend finds no ``meter`` attribute and skips every hook.
    """

    def __init__(self, inner, *, meter: WaveMeter | None = None,
                 recorder: TraceRecorder | None = None,
                 geometry: KVGeometry | None = None,
                 energy_model: power.DRAMEnergyModel | None = None,
                 sectored_hw: bool = True, background: bool = False,
                 audit: bool = True):
        self.inner = inner
        if meter is None:
            if geometry is None:
                geom_fn = getattr(inner, "kv_geometry", None)
                if geom_fn is None:
                    raise ValueError(
                        f"{type(inner).__name__} exposes no kv_geometry(); "
                        f"pass geometry=KVGeometry(...) explicitly")
                geometry = geom_fn()
            meter = WaveMeter(geometry, recorder=recorder,
                              energy_model=energy_model,
                              sectored_hw=sectored_hw,
                              background=background, audit=audit)
        self.meter = meter

    # data path: identity-stable delegation ---------------------------------

    @property
    def prefill_fn(self):
        return self.inner.prefill_fn

    @property
    def decode_fn(self):
        return self.inner.decode_fn

    @property
    def sectored_fn(self):
        return self.inner.sectored_fn

    @property
    def demand_merge_fn(self):
        return self.inner.demand_merge_fn

    @property
    def supports_sectored(self) -> bool:
        return self.inner.supports_sectored

    def sectored_fn_for(self, topk_frac: float | None):
        return self.inner.sectored_fn_for(topk_frac)

    def merge_demands(self, stacked_state: Any, group_ids: Any) -> Any:
        self.meter.totals["demand_merges"] += 1
        return self.inner.merge_demands(stacked_state, group_ids)

    def k_for(self, topk_frac: float | None = None) -> int | None:
        """The page budget the policy's fraction resolves to, when the
        inner backend can say (``SectoredKVBackend.k_for``); None keeps the
        meter in full-fetch accounting."""
        inner_k = getattr(self.inner, "k_for", None)
        return None if inner_k is None else inner_k(topk_frac)

    def __getattr__(self, name: str):
        # transparent decorator tail: optional hooks this class does not
        # intercept (a backend's kv_geometry, probe_pages_for, graphs,
        # device, vocab, ...) pass through so MeteredBackend composes with
        # other decorators in either order. Data-path identity still goes
        # through the explicit properties above.
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self.inner, name)

    def __repr__(self) -> str:
        return f"MeteredBackend({self.inner!r})"
