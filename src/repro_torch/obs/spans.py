"""FlightRecorder: request-lifecycle span tracing on the virtual step clock
(counterpart of the JAX package's ``obs/spans.py``).

Every request emits a span tree —

    request
      queued            (submit -> admit; re-opened on every preemption)
      prefill           (instant: cold | warm | resume, prefix_hit_tokens)
      running           (admit -> finish-or-preempt)
      preempt/truncated (instants)

— and the session emits one ``wave`` span per decode step carrying
occupancy, sector coverage, pool pages held, and metered joules. All
timestamps are the **virtual step clock** (`advance()` increments it at
the top of every ``ServeSession.step()``), never wall-clock: two runs of
the same trace produce identical span trees byte-for-byte, which is what
lets exports double as CI artifacts with stable diffs.

The recorder is discovered by the serving stack the same way meters and
mesh hooks are: ``ServeSession`` checks ``self.obs is not None`` (one
branch, zero-cost when absent), schedulers and ``KVPagePool`` look it up
with ``getattr``. Every hook is pure host bookkeeping — no device ops, no
RNG, no mutation of any serving state, no read of a device tensor and no
``torch.cuda.synchronize`` — which is the mechanism behind the
observer-effect oracle (tracing on vs. off yields bit-identical streams,
logprobs, and joules; asserted in tests/test_torch_obs.py and by
``chip_smoke.py`` on the card).
"""

from __future__ import annotations

from typing import Any, Mapping

from .metrics import MetricsRegistry

#: energy-record fields copied onto wave spans — deterministic host-side
#: counters only; wall_s is deliberately absent (it would break the
#: byte-identical-export half of the observer-effect oracle)
WAVE_ENERGY_FIELDS = ("energy_j", "act_j", "rd_j", "wr_j", "pages_fetched",
                      "pages_valid", "sector_coverage", "attn_mass",
                      "attn_mass_raw", "k_pages", "dram_ns")

#: histogram buckets for per-wave joules (DRAM waves sit well under 1 J)
ENERGY_BUCKETS = (1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 1e-1, 3e-1, 1.0)

#: histogram buckets for modeled DRAM service times (nanoseconds): decode
#: waves run hundreds of ns, prefill passes tens of µs
DRAM_NS_BUCKETS = (50.0, 100.0, 250.0, 500.0, 1e3, 2.5e3, 5e3, 1e4,
                   2.5e4, 5e4, 1e5, 2.5e5)

SESSION_TRACK = "session"


class FlightRecorder:
    """Deterministic span + metrics recorder for one serving session.

    Pass as ``ServeSession(obs=FlightRecorder())``; read back via
    :meth:`spans`, :attr:`metrics` / :meth:`snapshot`, and the exporters
    in :mod:`repro_torch.obs.export`.
    """

    def __init__(self, metrics: MetricsRegistry | None = None,
                 commands: bool = False):
        self.step = 0
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._spans: list[dict[str, Any]] = []  # in open order (stable)
        self._open: dict[tuple[Any, str], dict[str, Any]] = {}
        self._seq = 0
        self.session = None
        self.pool = None
        self.prefix_cache = None
        self.meter = None
        # DRAM command tracing (``commands=True``): keep each metered
        # wave's/prefill's replayed command timeline as a JSON-ready
        # record for the command-track exports. Pure copies of host
        # bookkeeping the meter produced anyway — the observer-effect
        # contract extends to this flag.
        self.trace_commands = commands
        self.command_records: list[dict[str, Any]] = []

    # -- wiring ------------------------------------------------------------

    def bind(self, session) -> None:
        """Attach to a session: keep refs to the optional collaborators
        (pool / prefix cache / meter, all may be None) and install the
        getattr-discovered pool hook."""
        self.session = session
        self.pool = getattr(session, "page_pool", None)
        self.prefix_cache = getattr(session, "prefix_cache", None)
        self.meter = getattr(session, "meter", None)
        if self.pool is not None:
            self.pool.obs = self  # KVPagePool.observe() reports through this

    # -- span plumbing -----------------------------------------------------

    def _span(self, track, name: str, *, start: int | None = None,
              end: int | None = None, attrs: Mapping | None = None) -> dict:
        rec = {"track": track, "name": name, "seq": self._seq,
               "start": self.step if start is None else start, "end": end}
        if attrs:
            rec["attrs"] = dict(attrs)
        self._seq += 1
        self._spans.append(rec)
        return rec

    def _open_span(self, track, name: str,
                   attrs: Mapping | None = None) -> dict:
        rec = self._span(track, name, attrs=attrs)
        self._open[(track, name)] = rec
        return rec

    def _close_span(self, track, name: str,
                    attrs: Mapping | None = None) -> dict | None:
        rec = self._open.pop((track, name), None)
        if rec is not None:
            rec["end"] = self.step
            if attrs:
                rec.setdefault("attrs", {}).update(attrs)
        return rec

    def _instant(self, track, name: str,
                 attrs: Mapping | None = None) -> dict:
        return self._span(track, name, end=self.step, attrs=attrs)

    def spans(self) -> list[dict[str, Any]]:
        """All spans in open order; still-open spans have ``end=None``."""
        return list(self._spans)

    # -- session hooks (called by ServeSession / schedulers / pool) --------

    def advance(self) -> None:
        """Tick the virtual step clock (top of every session step)."""
        self.step += 1

    def on_submit(self, handle) -> None:
        self.metrics.counter("requests_submitted").inc()
        self._open_span(handle.rid, "request", attrs={
            "prompt_tokens": len(handle.request.prompt),
            "max_new_tokens": int(handle.request.max_new_tokens)})
        self._open_span(handle.rid, "queued")

    def on_admit(self, slot: int, handle) -> None:
        """Called at slot activation, before the prefill token is emitted."""
        rid = handle.rid
        queued = self._close_span(rid, "queued")
        if queued is not None:
            self.metrics.histogram("queue_wait_steps").observe(
                self.step - queued["start"])
        lease = handle._lease
        hit = (int(lease.matched_tokens)
               if lease is not None and not lease.released else 0)
        resumed = bool(handle._tokens)  # generated tokens survive preemption
        mode = "resume" if resumed else ("warm" if hit else "cold")
        self.metrics.counter(f"prefill_{mode}").inc()
        if hit:
            self.metrics.counter("prefix_hit_tokens").inc(hit)
        prefill_attrs = {
            "mode": mode, "slot": slot, "prefix_hit_tokens": hit,
            "prefill_tokens": handle.prefill_len}
        tl = (self.meter.prefill_timelines.get(rid)
              if self.meter is not None else None)
        if tl is not None:
            prefill_attrs["dram_ns"] = tl.dram_ns
            self.metrics.histogram("prefill_dram_ns",
                                   DRAM_NS_BUCKETS).observe(tl.dram_ns)
            if self.trace_commands:
                self.command_records.append(tl.to_record(
                    step=self.step, kind="prefill", rid=rid,
                    seq=len(self.command_records)))
        self._instant(rid, "prefill", attrs=prefill_attrs)
        self._open_span(rid, "running", attrs={"slot": slot, "mode": mode})

    def on_preempt(self, slot: int, handle) -> None:
        rid = handle.rid
        self.metrics.counter("preemptions").inc()
        self._close_span(rid, "running", attrs={"preempted": True})
        self._instant(rid, "preempt", attrs={
            "slot": slot, "tokens_kept": len(handle._tokens)})
        self._open_span(rid, "queued", attrs={"resume": True})

    def on_finish(self, slot: int, handle, reason: str) -> None:
        rid = handle.rid
        self._close_span(rid, "running")
        root = self._close_span(rid, "request", attrs={
            "reason": reason, "tokens": len(handle._tokens),
            "preemptions": handle.preemptions})
        self.metrics.counter("requests_completed").inc()
        if reason == "eos":
            self.metrics.counter("eos_stops").inc()
        self.metrics.histogram("tokens_per_request").observe(
            len(handle._tokens))
        if root is not None:
            self.metrics.histogram("request_steps").observe(
                self.step - root["start"])
        if self.meter is not None:
            # modeled latency rollup: TTFT is the prefill pass's DRAM
            # service time, TPOT the per-token share of the decode waves
            # the request sat through — modeled ns, never wall-clock
            stats = self.meter.request_stats(rid)
            if stats and stats.get("prefill_dram_ns", 0.0) > 0:
                self.metrics.histogram("ttft_dram_ns",
                                       DRAM_NS_BUCKETS).observe(
                    stats["prefill_dram_ns"])
                tokens = stats.get("tokens", 0)
                if tokens > 1:
                    decode_ns = stats["dram_ns"] - stats["prefill_dram_ns"]
                    self.metrics.histogram("tpot_dram_ns",
                                           DRAM_NS_BUCKETS).observe(
                        decode_ns / (tokens - 1))

    def on_truncated(self, handle=None) -> None:
        """A ``StreamTruncated`` overran the step budget: the request (or
        the whole drain loop) is abandoned mid-flight. Spans stay open —
        the stream genuinely did not finish — but the cut is recorded."""
        self.metrics.counter("truncated_streams").inc()
        track = SESSION_TRACK if handle is None else handle.rid
        self._instant(track, "truncated")

    def on_schedule(self, *, queue_depth: int, ready: int,
                    scheduler: str) -> None:
        self.metrics.gauge("queue_depth").set(queue_depth)
        self.metrics.gauge("ready_prefills").set(ready)

    def on_pool(self, held_pages: int) -> None:
        """KVPagePool.observe() passthrough (installed by :meth:`bind`)."""
        self.metrics.gauge("pool_pages_held").set(held_pages)

    def on_wave(self, *, active_rids: list[tuple[int, int]], produced: int,
                sectored: bool, energy: Mapping | None,
                timeline=None) -> None:
        """One decode wave just completed (called after the meter, if any,
        recorded it). ``active_rids`` is [(slot, rid), ...] captured
        before finished slots vacated; ``energy`` is the meter's wave
        record (deterministic fields are copied, wall-clock is not);
        ``timeline`` is the meter's replayed ``CommandTimeline`` for the
        wave (recorded when command tracing is on)."""
        m = self.metrics
        m.counter("waves").inc()
        m.counter("tokens_emitted").inc(produced)
        if sectored:
            m.counter("sectored_waves").inc()
        session = self.session
        occupancy = (len(active_rids) / session.max_batch
                     if session is not None and session.max_batch else 0.0)
        m.gauge("wave_occupancy").set(occupancy)
        m.histogram("wave_active_slots").observe(len(active_rids))
        attrs: dict[str, Any] = {
            "slots": [[int(s), int(r)] for s, r in active_rids],
            "occupancy": occupancy, "produced": produced,
            "sectored": sectored}
        if self.pool is not None and session is not None:
            attrs["pool_pages_held"] = session._held_pages_total()
        if energy is not None:
            for field in WAVE_ENERGY_FIELDS:
                value = energy.get(field)
                if value is not None:
                    attrs[field] = float(value)
            if "energy_j" in attrs:
                m.counter("energy_j_total").inc(attrs["energy_j"])
                m.histogram("wave_energy_j", ENERGY_BUCKETS).observe(
                    attrs["energy_j"])
            if "dram_ns" in attrs:
                m.counter("dram_ns_total").inc(attrs["dram_ns"])
                m.histogram("wave_dram_ns", DRAM_NS_BUCKETS).observe(
                    attrs["dram_ns"])
        if self.meter is not None:
            # double-entry audit books (pure reads of meter totals)
            m.gauge("audit_checks").set(self.meter.totals["audit_checks"])
            m.gauge("audit_max_rel_err").set(
                self.meter.totals["audit_max_rel_err"])
        if self.trace_commands and timeline is not None:
            self.command_records.append(timeline.to_record(
                step=self.step, kind="wave", seq=len(self.command_records),
                sectored=sectored))
        if self.prefix_cache is not None:
            m.gauge("prefix_hit_rate").set(self.prefix_cache.hit_rate)
        # the wave owns the step interval it just executed: [step, step+1)
        self._span(SESSION_TRACK, "wave", start=self.step,
                   end=self.step + 1, attrs=attrs)

    # -- reporting ---------------------------------------------------------

    def snapshot(self) -> dict:
        """Deterministic metrics snapshot plus derived serving ratios."""
        snap = self.metrics.snapshot()
        tokens = snap.get("tokens_emitted", 0)
        energy = snap.get("energy_j_total")
        if energy is not None and tokens:
            snap["j_per_token"] = float(energy) / float(tokens)
        dram = snap.get("dram_ns_total")
        if dram is not None and tokens:
            snap["dram_ns_per_token"] = float(dram) / float(tokens)
        return snap
