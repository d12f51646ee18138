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
with ``getattr``. Every hook is host bookkeeping — no kernel launch, no
RNG, no mutation of any serving state, no read of a device tensor and no
``torch.cuda.synchronize`` — which is the mechanism behind the
observer-effect oracle (tracing on vs. off yields bit-identical streams,
logprobs, and joules; asserted in tests/test_torch_obs.py and by
``chip_smoke.py`` on the card).

**Wall mode** (``FlightRecorder(wall=True)``) keeps, beside the virtual
spans and apart from them (``spans()``, ``snapshot()`` and the exports
stay byte-identical), wall records on ``time.perf_counter_ns()``: the
session's ``step`` → ``schedule`` / ``wave`` / ``read`` / ``emit``, and
per request ``queued`` (submit → its admission) and ``admit`` →
``prefill``, ``first_token``, ``install``; inside ``wave``, ``merge``
(the demand merge) and ``replay`` (the wave's graph and the copies of
its tokens out). On the card it records CUDA events — a pair around
each span that enqueues device work, from a pool made ahead and topped
up while the host waits on the wave, and an *anchor* right after each
token read, when the device has just drained — but launches no kernel,
records nothing while a stream captures and never synchronizes before
:meth:`resolve`, which runs after the window: it places each device
interval on the host clock from the anchor before it (so the GPU
timer's drift never builds over more than a step), charges each idle
instant of the device to the innermost host span open then, and returns
the idle time by span, the longest gaps, the device seconds by span,
the queue waits, the kernel nodes the waves replayed and the graphs
captured; the events it read go back to the pool. Idle time inside a
host-paced eager call counts as busy: only a kernel trace sees inside
it.
"""

from __future__ import annotations

import bisect
import time
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

#: wall spans that enqueue device work: a CUDA event pair each on the card
#: (``replay``: the wave's graph and the copies of its tokens out;
#: ``merge``: the demand merge before it)
DEVICE_SPANS = frozenset({"prefill", "first_token", "install", "merge",
                          "replay"})
#: wall spans of a request that may outlast the step they begin in: no
#: host parent
REQUEST_ROOTS = frozenset({"queued", "admit"})
#: timing events made ahead when a CUDA session attaches: a sectored step
#: takes five (the replay's pair, the merge's pair, the anchor), a dense
#: one three, an admission six a request
EVENT_CHUNK = 16384
#: with fewer events than this free, a token read or a step's close makes
#: EVENT_BATCH more
EVENT_RESERVE = 1024
EVENT_BATCH = 64
#: the name of device idle time outside every ``step`` span
OUTSIDE = "outside"


class EventPool:
    """CUDA timing events made ahead (:data:`EVENT_CHUNK`), each recorded
    once so its driver event exists before a window needs it (``make``
    makes one). The recorder calls :meth:`top_up` where the host waits on
    the device anyway (the token read, behind the wave) and between
    steps, never inside a device span. A :meth:`take` that finds none
    makes a batch in place and counts a stall: that host time lies inside
    a device span and reads as busy. :meth:`FlightRecorder.resolve` gives
    the events it read back."""

    def __init__(self, make=None):
        if make is None:
            import torch

            def make():
                return torch.cuda.Event(enable_timing=True)
        self._make = make
        self._free: list = []
        self.stalls = 0
        self._add(EVENT_CHUNK)

    def _add(self, n: int) -> None:
        for _ in range(n):
            ev = self._make()
            ev.record()
            self._free.append(ev)

    def take(self):
        if not self._free:
            self.stalls += 1
            self._add(EVENT_BATCH)
        return self._free.pop()

    def top_up(self) -> None:
        if len(self._free) < EVENT_RESERVE:
            self._add(EVENT_BATCH)

    def give_back(self, events) -> None:
        self._free.extend(events)


def idle_report(intervals, hosts, t0: int, t1: int, top: int = 10) -> dict:
    """Device time and idle time of ``[t0, t1)`` (host ns), from device
    ``intervals`` ``[(start, end), ...]`` and the host's spans ``[(start,
    end, name, is_step), ...]``: busy and idle seconds; ``idle_by_span``,
    each idle instant charged to the innermost host span open then
    (:data:`OUTSIDE` outside every step span; a gap begins while the host
    still waits on the work that drained the device, so its length goes
    to what the host did next); and the ``top`` longest gaps, as ``[name
    of the innermost span open where it began, seconds]``."""
    clipped = sorted((max(a, t0), min(b, t1)) for a, b in intervals
                     if b > t0 and a < t1)
    gaps, busy, end = [], 0, t0
    for a, b in clipped:
        if a > end:
            gaps.append((end, a))
        if b > end:
            busy += b - max(a, end)
            end = b
    if end < t1:
        gaps.append((end, t1))
    # the innermost open span from each boundary on: spans open in start
    # order, so the latest-started open one is the top of the stack
    hosts = [h for h in hosts if h[1] > h[0]]
    bounds = sorted([(a, 1, i) for i, (a, _, _, _) in enumerate(hosts)]
                    + [(b, 0, i) for i, (_, b, _, _) in enumerate(hosts)])
    times, names = [t0], [OUTSIDE]
    stack: list[int] = []
    steps = 0
    for t, opening, i in bounds:
        if opening:
            stack.append(i)
        else:
            stack.remove(i)
        steps += (1 if opening else -1) if hosts[i][3] else 0
        times.append(max(t, t0))
        names.append(hosts[stack[-1]][2] if stack and steps else OUTSIDE)
    by_name: dict[str, float] = {}
    named = []
    for a, b in gaps:
        k = bisect.bisect_right(times, a) - 1
        named.append([names[k], (b - a) / 1e9])
        while a < b:
            nxt = times[k + 1] if k + 1 < len(times) else b
            upto = min(max(nxt, a), b)
            if upto > a:
                by_name[names[k]] = (by_name.get(names[k], 0.0)
                                     + (upto - a) / 1e9)
            a = upto
            k += 1
    named.sort(key=lambda g: -g[1])
    return dict(busy_s=busy / 1e9, idle_s=sum(b - a for a, b in gaps) / 1e9,
                idle_by_span=by_name, idle_gaps=named[:top])


def _listed(span: dict[str, Any]) -> dict[str, Any]:
    """A span as the reference records it: a wave's ``slots``, kept as
    the ``(slot, rid)`` pairs the session gave, come out as lists of
    ``[int(slot), int(rid)]``."""
    attrs = span.get("attrs")
    if not attrs or "slots" not in attrs:
        return span
    slots = [[int(s), int(r)] for s, r in attrs["slots"]]
    return {**span, "attrs": {**attrs, "slots": slots}}


class FlightRecorder:
    """Deterministic span + metrics recorder for one serving session.

    Pass as ``ServeSession(obs=FlightRecorder())``; read back via
    :meth:`spans`, :attr:`metrics` / :meth:`snapshot`, and the exporters
    in :mod:`repro_torch.obs.export`.
    """

    def __init__(self, metrics: MetricsRegistry | None = None,
                 commands: bool = False, wall: bool = False):
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
        # wall mode: records on the host clock, CUDA events on the card
        self.wall = wall
        self._wall: list[dict[str, Any]] = []  # in open order
        self._wall_stack: list[dict[str, Any]] = []  # open session spans
        self._wall_open: dict[tuple[Any, str], dict[str, Any]] = {}
        # recorded events in order (None once resolve() gave them back),
        # the host ns of those that are anchors, and of each mark placed
        # (no per-event container: the collector need not walk a long
        # window's records)
        self._marks: list = []
        self._anchors: dict[int, int] = {}
        self._host: list[int] = []
        self._events: EventPool | None = None  # on a CUDA session
        self._capturing = None
        self._current_stream = None
        self._stream = None  # the stream a step began on (None: look up)
        self._replayed = None  # runtime.graphs.REPLAYED
        self._captures_seen = 0
        self._queued_since_wave = False  # device work behind the wave
        #: ``(step, host ns of the step's start, graphs)`` of each step
        #: whose graphs were captured while it ran
        self.captures: list[tuple[int, int, int]] = []
        #: ``[{name, rid, index, start, end}, ...]`` (host ns; ``index``:
        #: the wall record's), set by resolve()
        self.device_intervals: list[dict[str, Any]] = []

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
        if self.wall:
            from repro_torch.runtime.graphs import REPLAYED
            self._replayed = REPLAYED
            self._captures_seen = REPLAYED.captures
            device = getattr(session, "device", None)
            if device is not None and device.type == "cuda":
                import torch
                self._capturing = torch.cuda.is_current_stream_capturing
                self._current_stream = torch.cuda.current_stream
                self._events = EventPool()

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
        return [_listed(span) for span in self._spans]

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
        if self.wall:
            self.wall_open("queued", handle.rid)

    def on_admit_begin(self, handle) -> None:
        """The request leaves the queue: its admission work starts (the
        prefill, or a group's). Wall mode only."""
        if self.wall:
            self.wall_close("queued", handle.rid)
            self.wall_open("admit", handle.rid,
                           prompt_tokens=handle.prefill_len)

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
        if self.wall:
            self.wall_open("queued", rid, resume=True)

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
            # the pairs as given, in a tuple the collector stops tracking:
            # spans() gives them as the reference's lists of ints
            "slots": tuple(active_rids),
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

    # -- wall mode -------------------------------------------------------

    def _device_ok(self) -> bool:
        return self._events is not None and not self._capturing()

    def _mark(self, anchor: bool = False) -> int:
        """Record the next pool event on the current stream; an anchor
        is queried at once (the driver may hold a lone record back until
        the next launch; a query submits it) and keeps the host time right
        after."""
        ev = self._events.take()
        ev.record(self._stream)
        self._marks.append(ev)
        if anchor:
            ev.query()
            self._anchors[len(self._marks) - 1] = time.perf_counter_ns()
        return len(self._marks) - 1

    def wall_open(self, name: str, rid=None, **attrs) -> None:
        """Open a wall span: a session span (``rid`` None) nests in the
        innermost open one; a request's ``queued``/``admit`` has no
        parent, and its other spans nest in its open ``admit``."""
        if not self.wall:
            return
        now = time.perf_counter_ns()
        stack = self._wall_stack
        parent = stack[-1]["index"] if stack else None
        if name in REQUEST_ROOTS:
            parent = None
        elif rid is not None:
            admit = self._wall_open.get((rid, "admit"))
            if admit is not None:
                parent = admit["index"]
        rec = {"name": name, "index": len(self._wall), "start": now,
               "end": None, "parent": parent, "rid": rid}
        if attrs:
            rec["attrs"] = attrs
        if name in DEVICE_SPANS and self._device_ok():
            rec["ev0"] = self._mark()
            self._queued_since_wave = True
        if name == "wave" and self._replayed is not None:
            r = self._replayed
            rec["nodes0"] = (r.graphs, r.kernel, r.memcpy, r.memset)
        elif name == "step" and self._events is not None:
            # a step's work runs on the stream it began on; looking the
            # stream up once saves most of an event record's host time
            self._stream = self._current_stream()
        self._wall.append(rec)
        if rid is None:
            stack.append(rec)
        else:
            self._wall_open[(rid, name)] = rec
        if name == "read" and self._events is not None:
            self._events.top_up()  # while the device runs the wave

    def wall_close(self, name: str, rid=None, anchor: bool = False,
                   **attrs) -> None:
        """Close the open wall span ``name`` (a session span closes the
        spans left open inside it too; closing one that is not open does
        nothing). ``anchor``: the device has just drained (a token read),
        so an anchor event is recorded unless device work was queued
        behind the wave."""
        if not self.wall:
            return
        if rid is None:
            stack = self._wall_stack
            j = len(stack) - 1
            while j >= 0 and stack[j]["name"] != name:
                j -= 1
            if j < 0:
                return
            closing = stack[j:]
            del stack[j:]
        else:
            rec = self._wall_open.pop((rid, name), None)
            if rec is None:
                return
            closing = [rec]
        for rec in reversed(closing):
            if "ev0" in rec and self._device_ok():
                rec["ev1"] = self._mark()
            rec["end"] = time.perf_counter_ns()
        rec = closing[0]
        if attrs:
            rec.setdefault("attrs", {}).update(attrs)
        if name == "wave":
            self._queued_since_wave = False
            if "nodes0" in rec:
                # None where the wave replayed no graph whose nodes were
                # counted (off the card, eager waves)
                r, n0 = self._replayed, rec.pop("nodes0")
                counted = r.graphs > n0[0]
                rec.setdefault("attrs", {}).update(
                    kernel_nodes=r.kernel - n0[1] if counted else None,
                    memcpy_nodes=r.memcpy - n0[2] if counted else None,
                    memset_nodes=r.memset - n0[3] if counted else None)
        elif name == "step" and self._replayed is not None:
            self._stream = None
            new = self._replayed.captures - self._captures_seen
            if new:
                self._captures_seen += new
                self.captures.append((self.step, rec["start"], new))
            if self._events is not None:
                self._events.top_up()  # where no read did
        if anchor and self._device_ok() and not self._queued_since_wave:
            self._mark(anchor=True)

    def wall_spans(self) -> list[dict[str, Any]]:
        """The wall records in open order: ``name``, ``index``, ``start``
        and ``end`` (host ns; ``end`` None while open), ``parent`` (an
        index or None), ``rid`` (None on the session's spans) and
        ``attrs`` where there are any."""
        keep = ("name", "index", "start", "end", "parent", "rid", "attrs")
        return [{k: r[k] for k in keep if k in r} for r in self._wall]

    def _place_marks(self) -> list[int]:
        """Each mark's host time: the anchor recorded last before it plus
        the device time between them (the first anchor after it, for a
        mark before every anchor). Synchronizes once, records a last
        anchor on the drained device, places the marks recorded since the
        last call and gives their events back to the pool, all but that
        anchor's, which places the next call's."""
        import torch
        torch.cuda.synchronize()
        self._mark(anchor=True)
        marks, at, host = self._marks, self._anchors, self._host
        first, last = len(host), len(marks) - 1
        anchors = sorted(at)
        k = bisect.bisect_right(anchors, first - 1) - 1
        for i in range(first, len(marks)):
            while k + 1 < len(anchors) and anchors[k + 1] <= i:
                k += 1
            ev = marks[i]
            if i in at:
                host.append(at[i])
            elif k >= 0:
                a = anchors[k]
                host.append(at[a] + round(marks[a].elapsed_time(ev) * 1e6))
            else:
                a = anchors[0]
                host.append(at[a] - round(ev.elapsed_time(marks[a]) * 1e6))
        done = range(max(first - 1, 0), last)
        self._events.give_back([marks[i] for i in done])
        for i in done:
            marks[i] = None
        return host

    def resolve(self, t0: int | None = None,
                t1: int | None = None) -> dict[str, Any]:
        """The wall records' numbers over ``[t0, t1)`` (host ns; default:
        the first step's start to the last step's end), read after the
        window: ``window_s``; ``queue_wait_s`` (each request whose
        admission began in the window: its start less its submission);
        ``waves`` begun in the window and the kernel, memcpy and memset
        nodes they replayed (None where a wave replayed no counted graph,
        or no wave began);
        ``prefill_tokens`` of the prefills begun in the window;
        ``graph_captures`` in the window; and on the card ``busy_s``,
        ``idle_s``, ``idle_by_span``, ``idle_gaps`` (:func:`idle_report`)
        and ``device_s`` (device seconds by span name, of the spans begun
        in the window; None off the card), with ``early_s``, the most by
        which a device interval seems to start before the host span that
        enqueued it (a check of the placement: the device cannot start
        work before it is sent), and ``event_stalls``, the events the
        pool made inside a span since the recorder attached (0 unless a
        step took more than its reserve). Sets :attr:`device_intervals`.
        A later call places the events recorded since, so a long run can
        call it now and then to give the events it read back to the
        pool."""
        steps = [r for r in self._wall
                 if r["name"] == "step" and r["end"] is not None]
        if t0 is None:
            t0 = steps[0]["start"] if steps else 0
        if t1 is None:
            t1 = steps[-1]["end"] if steps else 0

        def inside(t):
            return t0 <= t < t1

        out: dict[str, Any] = {"window_s": (t1 - t0) / 1e9}
        out["queue_wait_s"] = [
            (r["end"] - r["start"]) / 1e9 for r in self._wall
            if r["name"] == "queued" and r["end"] is not None
            and inside(r["end"]) and not r.get("attrs", {}).get("resume")]
        waves = [r for r in self._wall
                 if r["name"] == "wave" and inside(r["start"])]
        out["waves"] = len(waves)
        for kind in ("kernel", "memcpy", "memset"):
            counts = [r.get("attrs", {}).get(f"{kind}_nodes")
                      for r in waves]
            out[f"wave_{kind}_nodes"] = (
                sum(counts) if counts and None not in counts else None)
        out["prefill_tokens"] = sum(
            r.get("attrs", {}).get("tokens", 0) for r in self._wall
            if r["name"] == "prefill" and inside(r["start"]))
        out["graph_captures"] = sum(n for _, t, n in self.captures
                                    if inside(t))
        if self._events is None:
            out.update(busy_s=None, idle_s=None, idle_by_span=None,
                       idle_gaps=None, device_s=None, early_s=None,
                       event_stalls=None)
            return out
        out["event_stalls"] = self._events.stalls
        host = self._place_marks()
        timed = [r for r in self._wall if "ev1" in r]
        self.device_intervals = [
            {"name": r["name"], "rid": r["rid"], "index": r["index"],
             "start": host[r["ev0"]], "end": host[r["ev1"]]} for r in timed]
        hosts = [(r["start"], r["end"] if r["end"] is not None else t1,
                  r["name"], r["name"] == "step")
                 for r in self._wall if r["name"] != "queued"]
        out.update(idle_report(
            [(d["start"], d["end"]) for d in self.device_intervals],
            hosts, t0, t1))
        device_s: dict[str, float] = {}
        for r, d in zip(timed, self.device_intervals):
            if inside(r["start"]):
                device_s[d["name"]] = (device_s.get(d["name"], 0.0)
                                       + (d["end"] - d["start"]) / 1e9)
        out["device_s"] = device_s
        out["early_s"] = max(
            ((self._wall[d["index"]]["start"] - d["start"]) / 1e9
             for d in self.device_intervals), default=None)
        return out

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
