"""The port's flight recorder against the JAX reference: the metrics
registry, request span trees on the virtual step clock, the exporters,
and the observer-effect oracle (the oracles of tests/test_obs.py).

Over the resume-consistent toy backend (``_torch_port.sum_backend``) the
same trace runs through the reference session with the reference's
recorder and through the port's: the span lists, the metrics snapshots
and the JSONL / Perfetto files must be identical, byte for byte. Over
the port's metered ``SectoredKVBackend`` on the reduced yi-6b, tracing
on and off must give the same tokens, logprobs and joules.
"""

import json

import numpy as np
import pytest

from _torch_port import (expected_sum_stream, jax_sum_backend, small_models,
                         sum_backend)
from _torch_port import one_torch_thread  # noqa: F401  (autouse)
from repro import obs as jobs
from repro import serve as jserve
from repro_torch import obs as pobs
from repro_torch import serve
from repro_torch.obs import (SESSION_TRACK, TRACE_SCHEMA_VERSION, US_PER_STEP,
                             FlightRecorder, MetricsRegistry,
                             command_trace_events, to_trace_events,
                             write_jsonl, write_perfetto)
from repro_torch.obs.metrics import Counter, Gauge, Histogram
from repro_torch.runtime import sectored_decode
from repro_torch.serve import (AlwaysDense, FifoScheduler, KVPagePool,
                               OverlapScheduler, PrefixCache, Request,
                               ServeSession, StreamTruncated)
from repro_torch.telemetry import MeteredBackend


def _spans_by(obs, track, name=None):
    return [s for s in obs.spans()
            if s["track"] == track and (name is None or s["name"] == name)]


# -- metrics registry ----------------------------------------------------------


def test_counter_gauge_histogram():
    c = Counter("tokens")
    c.inc()
    c.inc(4)
    assert c.snapshot() == 5
    with pytest.raises(ValueError, match="cannot decrease"):
        c.inc(-1)
    g = Gauge("depth")
    for v in (3, 7, 1):
        g.set(v)
    assert g.snapshot() == {"value": 1, "min": 1, "max": 7}
    h = Histogram("steps", buckets=(1, 4, 16))
    for v in (0.5, 1, 3, 20, 100):
        h.observe(v)
    snap = h.snapshot()
    assert snap["count"] == 5 and snap["overflow"] == 2
    assert snap["buckets"] == {"1": 2, "4": 1, "+inf": 2}
    assert snap["min"] == 0.5 and snap["max"] == 100
    with pytest.raises(ValueError, match="strictly increasing"):
        Histogram("bad", buckets=(4, 4, 1))


def test_registry_matches_reference_snapshot_and_render():
    def feed(reg):
        reg.gauge("z_depth").set(2)
        reg.counter("a_waves").inc(3)
        hist = reg.histogram("m_wait")
        for v in (5, 0.25, 3000, 7):
            hist.observe(v)
        reg.histogram("e", buckets=(1e-4, 1e-3)).observe(5e-4)

    port, ref = MetricsRegistry(), jobs.MetricsRegistry()
    feed(port)
    feed(ref)
    assert json.dumps(port.snapshot()) == json.dumps(ref.snapshot())
    assert list(port.snapshot()) == sorted(port.snapshot())
    assert MetricsRegistry.render(port.snapshot()) == \
        jobs.MetricsRegistry.render(ref.snapshot())
    port.counter("x")
    with pytest.raises(ValueError, match="already registered"):
        port.gauge("x")


# -- span trees ----------------------------------------------------------------


def test_uncontended_request_span_tree():
    obs = FlightRecorder()
    sess = ServeSession(sum_backend(), max_batch=2, obs=obs)
    prompt = np.asarray([1, 2], np.int32)
    h = sess.submit(Request(0, prompt, max_new_tokens=5))
    sess.run_until_drained()
    assert h.peek() == expected_sum_stream(prompt, 5)
    (root,) = _spans_by(obs, 0, "request")
    assert root["attrs"]["reason"] == "quota" and root["attrs"]["tokens"] == 5
    (queued,) = _spans_by(obs, 0, "queued")
    (running,) = _spans_by(obs, 0, "running")
    (prefill,) = _spans_by(obs, 0, "prefill")
    assert queued["end"] == running["start"] == prefill["start"]
    assert prefill["attrs"]["mode"] == "cold"
    assert running["end"] == root["end"]
    waves = _spans_by(obs, SESSION_TRACK, "wave")
    assert len(waves) == sess.stats["waves"]
    assert all(w["end"] == w["start"] + 1 for w in waves)
    snap = obs.snapshot()
    assert snap["requests_submitted"] == snap["requests_completed"] == 1
    assert snap["tokens_emitted"] == sess.stats["decode_steps"]


@pytest.mark.parametrize("scheduler", [FifoScheduler, OverlapScheduler],
                         ids=["fifo", "overlap"])
def test_preempt_resume_eos_joint_lifecycle(scheduler):
    """Pool growth preempts the younger request, the survivor EOS-stops,
    the victim resumes: stats, metrics and the span tree agree."""
    obs = FlightRecorder()
    sess = ServeSession(sum_backend(), max_batch=4, scheduler=scheduler(),
                        page_pool=KVPagePool(4, page_size=4), obs=obs)
    p0 = np.asarray([1, 2, 3, 5], np.int32)
    p1 = np.asarray([2, 2, 3, 5], np.int32)
    h0 = sess.submit(Request(0, p0, max_new_tokens=8, stop_tokens=(0,)))
    h1 = sess.submit(Request(1, p1, max_new_tokens=8))
    sess.run_until_drained()
    assert h0.peek() == expected_sum_stream(p0, 8, stop=(0,)) and h0.stopped
    assert h1.peek() == expected_sum_stream(p1, 8)
    assert h1.preemptions > 0 and h0.preemptions == 0
    snap = obs.snapshot()
    assert snap["preemptions"] == sess.stats["preemptions"]
    assert snap["prefill_resume"] == h1.preemptions
    assert len(_spans_by(obs, 1, "queued")) == 1 + h1.preemptions
    prefills = _spans_by(obs, 1, "prefill")
    assert [p["attrs"]["mode"] for p in prefills] == \
        ["cold"] + ["resume"] * h1.preemptions
    assert _spans_by(obs, 0, "request")[0]["attrs"]["reason"] == "eos"
    assert not obs._open
    assert snap["pool_pages_held"]["max"] == sess.page_pool.peak_pages


def test_truncated_streams_leave_spans_open_and_count():
    obs = FlightRecorder()
    sess = ServeSession(sum_backend(), max_batch=1, max_stream_steps=3,
                        obs=obs)
    sess.submit(Request(0, np.arange(3, dtype=np.int32), max_new_tokens=8))
    h1 = sess.submit(Request(1, np.arange(3, dtype=np.int32),
                             max_new_tokens=8))
    with pytest.raises(StreamTruncated):
        list(h1.tokens())
    (cut,) = _spans_by(obs, 1, "truncated")
    assert cut["end"] == cut["start"]
    assert _spans_by(obs, 1, "request")[0]["end"] is None
    assert len(list(h1.tokens(max_steps=100))) > 0
    assert _spans_by(obs, 1, "request")[0]["attrs"]["reason"] == "quota"
    with pytest.raises(StreamTruncated):
        for rid in range(2, 6):
            sess.submit(Request(rid, np.arange(3, dtype=np.int32),
                                max_new_tokens=8))
        sess.run_until_drained(max_steps=2)
    assert obs.snapshot()["truncated_streams"] == 2
    assert len(_spans_by(obs, SESSION_TRACK, "truncated")) == 1


# -- parity with the reference recorder ---------------------------------------


def _traced(stack, obs_mod, backend, scheduler, **flavor):
    """A preempting, EOS-stopping, truncation-free trace under the
    recorder of ``obs_mod``; returns the recorder and the streams."""
    obs = obs_mod.FlightRecorder()
    sess = stack.ServeSession(backend, max_batch=3,
                              scheduler=getattr(stack, scheduler)(),
                              page_pool=stack.KVPagePool(6, page_size=4),
                              obs=obs, **flavor)
    handles = []
    for rid in range(4):
        prompt = np.asarray([rid + 1, 2, 3, 5], np.int32)
        handles.append(sess.submit(stack.Request(
            rid, prompt, max_new_tokens=8,
            stop_tokens=(0,) if rid == 0 else ())))
        if rid % 2:
            sess.step()  # staggered arrivals
    sess.run_until_drained()
    assert sess.stats["preemptions"] > 0
    return obs, [h.peek() for h in handles]


@pytest.mark.parametrize("case", [
    ("FifoScheduler", {}), ("OverlapScheduler", {}),
    ("FifoScheduler", dict(vectorized=False)),
    ("OverlapScheduler", dict(fuse_wave=False))],
    ids=["fifo", "overlap", "fifo_looped", "overlap_prefused"])
def test_spans_snapshot_and_exports_match_reference(case, tmp_path):
    """Same trace, both stacks: identical span lists, snapshots, and
    JSONL / Perfetto files byte for byte."""
    scheduler, flavor = case
    port, port_streams = _traced(serve, pobs, sum_backend(), scheduler,
                                 **flavor)
    ref, ref_streams = _traced(jserve, jobs, jax_sum_backend(), scheduler,
                               **flavor)
    assert port_streams == ref_streams
    assert port.spans() == ref.spans()
    assert json.dumps(port.snapshot(), sort_keys=True) == json.dumps(
        ref.snapshot(), sort_keys=True)
    extra = {"trace_schema_version": TRACE_SCHEMA_VERSION, "leg": "unit"}
    for writer, ref_writer, suffix in (
            (write_jsonl, jobs.write_jsonl, "jsonl"),
            (write_perfetto, jobs.write_perfetto, "json")):
        a = writer(port.spans(), tmp_path / f"port.{suffix}", extra=extra)
        b = ref_writer(ref.spans(), tmp_path / f"ref.{suffix}", extra=extra)
        assert a.read_bytes() == b.read_bytes()
    assert to_trace_events(port.spans()) == jobs.to_trace_events(
        ref.spans())


def test_perfetto_event_model(tmp_path):
    obs, _ = _traced(serve, pobs, sum_backend(), "FifoScheduler")
    events = to_trace_events(obs.spans())
    assert {e["ph"] for e in events} == {"M", "X", "i", "C"}
    names = [e["args"]["name"] for e in events if e["ph"] == "M"]
    assert names == ["request 0", "request 1", "request 2", "request 3",
                     SESSION_TRACK]
    waves = [e for e in events if e["ph"] == "X" and e["name"] == "wave"]
    assert waves and all(w["dur"] == US_PER_STEP for w in waves)
    counters = {e["name"] for e in events if e["ph"] == "C"}
    assert {"occupancy", "pool_pages_held"} <= counters
    a = write_perfetto(obs.spans(), tmp_path / "a.json")
    b = write_perfetto(_traced(serve, pobs, sum_backend(),
                               "FifoScheduler")[0].spans(),
                       tmp_path / "b.json")
    assert a.read_bytes() == b.read_bytes()  # reruns are byte-identical


# -- the observer-effect oracle ------------------------------------------------


@pytest.fixture(scope="module")
def models():
    return small_models()


def _metered_run(models, obs, flavor):
    """Overlap + pool + prefix cache over the metered SectoredKVBackend:
    shared-prefix prompts so warm admissions, preemption and resumes all
    happen."""
    _, cfg, _, params = models
    backend = MeteredBackend(sectored_decode.make_serving_fns(
        cfg, params=params, seq_len=48, device="cpu"))
    sess = ServeSession(backend, max_batch=3, scheduler=OverlapScheduler(),
                        policy=AlwaysDense(), obs=obs,
                        page_pool=KVPagePool(10, page_size=4),
                        prefix_cache=PrefixCache(16, page_size=4), **flavor)
    rng = np.random.default_rng(7)
    common = rng.integers(0, cfg.vocab, 12).astype(np.int32)
    handles = []
    for rid in range(5):
        tail = rng.integers(0, cfg.vocab, 4).astype(np.int32)
        handles.append(sess.submit(Request(
            rid, np.concatenate([common, tail]), max_new_tokens=6,
            sampler=(serve.SamplerSpec(temperature=0.8, seed=rid)
                     if rid % 2 else None))))
        sess.step()
    sess.run_until_drained()
    report = sess.meter.report()
    return sess, dict(
        streams=[(h.peek(), h.logprobs()) for h in handles],
        energy=[h.energy_j for h in handles],
        totals={k: report[k] for k in ("energy_j", "dram_ns",
                                       "prefill_dram_ns", "prefill_j")},
        stats=dict(sess.stats))


@pytest.mark.parametrize("flavor", [dict(), dict(vectorized=False)],
                         ids=["vectorized", "looped"])
def test_tracing_has_no_observer_effect(models, flavor):
    """Tracing on (with command timelines) and off: the same tokens,
    logprobs, per-request joules, totals and stats; the traced run's
    metrics mirror its stats."""
    _, off = _metered_run(models, None, flavor)
    obs = FlightRecorder(commands=True)
    sess, on = _metered_run(models, obs, flavor)
    assert on == off
    assert on["stats"]["preemptions"] > 0
    assert sess.prefix_cache.stats["hits"] > 0
    snap = obs.snapshot()
    assert snap["preemptions"] == on["stats"]["preemptions"]
    assert snap["tokens_emitted"] == on["stats"]["decode_steps"]
    assert snap["prefill_warm"] == sess.prefix_cache.stats["hits"]
    assert snap["energy_j_total"] > 0 and snap["audit_checks"]["max"] > 0
    assert obs.command_records
    assert command_trace_events(obs.command_records)[0]["ph"] == "M"


# -- wall mode -----------------------------------------------------------------

WALL_NAMES = {"step", "schedule", "wave", "replay", "read", "emit", "queued",
              "admit", "prefill", "first_token", "install"}


class _WallObs:
    """``obs_mod`` for :func:`_traced` whose recorder is in wall mode."""

    @staticmethod
    def FlightRecorder():
        return FlightRecorder(wall=True)


@pytest.mark.parametrize("flavor", [dict(), dict(vectorized=False)],
                         ids=["vectorized", "looped"])
def test_wall_mode_has_no_observer_effect(models, flavor, tmp_path):
    """Wall mode on and off: the same tokens, logprobs, joules and stats,
    and the same spans, snapshot and JSONL / Perfetto bytes."""
    off_obs = FlightRecorder(commands=True)
    _, off = _metered_run(models, off_obs, flavor)
    on_obs = FlightRecorder(commands=True, wall=True)
    _, on = _metered_run(models, on_obs, flavor)
    assert on == off
    assert on_obs.spans() == off_obs.spans()
    assert json.dumps(on_obs.snapshot(), sort_keys=True) == json.dumps(
        off_obs.snapshot(), sort_keys=True)
    for writer in (write_jsonl, write_perfetto):
        a = writer(on_obs.spans(), tmp_path / "on")
        b = writer(off_obs.spans(), tmp_path / "off")
        assert a.read_bytes() == b.read_bytes()
    assert on_obs.wall_spans() and not off_obs.wall_spans()


@pytest.mark.parametrize("case", [
    ("FifoScheduler", {}), ("OverlapScheduler", {}),
    ("FifoScheduler", dict(vectorized=False))],
    ids=["fifo", "overlap", "fifo_looped"])
def test_wall_mode_keeps_the_reference_spans(case):
    """A wall-mode recorder's virtual spans and snapshot still equal the
    reference recorder's on the preempting trace."""
    scheduler, flavor = case
    port, port_streams = _traced(serve, _WallObs, sum_backend(), scheduler,
                                 **flavor)
    ref, ref_streams = _traced(jserve, jobs, jax_sum_backend(), scheduler,
                               **flavor)
    assert port_streams == ref_streams
    assert port.spans() == ref.spans()
    assert json.dumps(port.snapshot(), sort_keys=True) == json.dumps(
        ref.snapshot(), sort_keys=True)


@pytest.mark.parametrize("case", [
    ("FifoScheduler", {}), ("OverlapScheduler", {}),
    ("FifoScheduler", dict(vectorized=False)),
    ("OverlapScheduler", dict(fuse_wave=False))],
    ids=["fifo", "overlap", "fifo_looped", "overlap_prefused"])
def test_wall_span_tree_is_well_formed(case):
    """Every wall span is closed and lies inside its parent; a request's
    queued, admit, prefill and first_token spans share its rid; queue
    waits are >= 0, one per admission from the queue."""
    scheduler, flavor = case
    obs, _ = _traced(serve, _WallObs, sum_backend(), scheduler, **flavor)
    wall = obs.wall_spans()
    # a looped wave reads each slot's token in the wave: no read span
    looped = flavor.get("vectorized") is False
    assert {w["name"] for w in wall} == WALL_NAMES - (
        {"read"} if looped else set())
    for w in wall:
        assert w["end"] is not None and w["end"] >= w["start"], w
        if w["parent"] is not None:
            p = wall[w["parent"]]
            assert p["start"] <= w["start"] and w["end"] <= p["end"], (w, p)
            if w["rid"] is not None and p["rid"] is not None:
                assert p["name"] == "admit" and p["rid"] == w["rid"]
        if w["name"] in ("queued", "admit"):
            assert w["parent"] is None and w["rid"] is not None
        if w["name"] in ("step", "schedule", "wave", "replay", "read",
                         "emit"):
            assert w["rid"] is None
    for rid in range(4):
        names = {w["name"] for w in wall if w["rid"] == rid}
        assert {"queued", "admit", "prefill", "first_token"} <= names, rid
    steps = [w for w in wall if w["name"] == "step"]
    assert len(steps) == obs.step
    # a request's queued span ends where its (first) admission begins
    for w in wall:
        if w["name"] == "queued":
            admits = [a for a in wall if a["name"] == "admit"
                      and a["rid"] == w["rid"] and a["start"] >= w["end"]]
            assert admits and admits[0]["start"] >= w["end"]
    r = obs.resolve()
    resumes = sum(1 for w in wall if w["name"] == "queued"
                  and (w.get("attrs") or {}).get("resume"))
    assert resumes > 0  # the trace preempts
    assert len(r["queue_wait_s"]) == 4 and min(r["queue_wait_s"]) >= 0
    assert r["waves"] == sum(1 for w in wall if w["name"] == "wave")
    # four 4-token prompts, then the resumes' longer re-prefills
    assert r["prefill_tokens"] > 16
    # off the card: no device intervals, no graph nodes
    assert r["idle_s"] is None and r["device_s"] is None
    assert r["wave_kernel_nodes"] is None and r["graph_captures"] == 0


def test_session_without_recorder_reads_no_clock(models, monkeypatch):
    """With ``obs=None`` a session step reads no nanosecond clock and
    makes no CUDA event: each wall boundary is one branch."""
    import time

    import torch

    def refuse(*_, **__):
        raise AssertionError("called with obs=None")

    _, cfg, _, params = models
    backend = sectored_decode.make_serving_fns(cfg, params=params,
                                               seq_len=48, device="cpu")
    sess = ServeSession(backend, max_batch=2)
    monkeypatch.setattr(time, "perf_counter_ns", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    rng = np.random.default_rng(3)
    handles = [sess.submit(Request(rid, rng.integers(
        0, cfg.vocab, 6).astype(np.int32), max_new_tokens=3))
        for rid in range(3)]
    sess.run_until_drained()
    assert all(len(h.peek()) == 3 for h in handles)


def test_idle_report_charges_idle_to_the_innermost_span():
    """Each idle instant is charged to the innermost host span open then
    (``outside`` beyond every step), so the names' idle time adds up to
    the total; the longest gaps are named where they begin."""
    hosts = [(0, 100, "step"), (5, 40, "schedule"), (10, 30, "admit"),
             (40, 90, "wave"), (80, 95, "read"), (100, 200, "step"),
             (150, 400, "admit")]  # outlasts its step
    hosts = [(a, b, n, n == "step") for a, b, n in hosts]
    intervals = [(12, 20), (15, 25), (45, 82), (120, 150), (300, 310)]
    r = pobs.idle_report(intervals, hosts, 0, 320, top=3)
    assert r["busy_s"] == pytest.approx((13 + 37 + 30 + 10) / 1e9)
    assert r["idle_s"] == pytest.approx((320 - 90) / 1e9)
    # gaps 0..12, 25..45, 82..120, 150..300 and 310..320, cut where the
    # innermost span changes
    assert r["idle_by_span"] == pytest.approx({
        "step": (5 + 5 + 20) * 1e-9, "schedule": (5 + 10) * 1e-9,
        "admit": (2 + 5 + 50) * 1e-9, "wave": 5e-9, "read": 13e-9,
        "outside": (100 + 10) * 1e-9})
    assert sum(r["idle_by_span"].values()) == pytest.approx(r["idle_s"])
    assert r["idle_gaps"] == [["admit", pytest.approx(150e-9)],
                              ["read", pytest.approx(38e-9)],
                              ["admit", pytest.approx(20e-9)]]
    empty = pobs.idle_report([], hosts, 0, 50)
    assert empty["idle_s"] == pytest.approx(50e-9) and empty["busy_s"] == 0
    assert sum(empty["idle_by_span"].values()) == pytest.approx(50e-9)


def test_wall_perfetto_export(tmp_path):
    """The wall export: host and device tracks, a complete slice for each
    closed host span but queued, queued as async slices per request."""
    obs, _ = _traced(serve, _WallObs, sum_backend(), "FifoScheduler")
    wall = obs.wall_spans()
    path = pobs.write_wall_perfetto(
        wall, tmp_path / "wall.json",
        [{"name": "wave", "rid": None, "start": wall[0]["start"] + 1000,
          "end": wall[0]["start"] + 3000}])
    events = json.loads(path.read_text())["traceEvents"]
    assert [e["args"]["name"] for e in events if e["ph"] == "M"] == [
        "host", "device"]
    slices = [e for e in events if e["ph"] == "X"]
    assert len([e for e in slices if e["tid"] == 0]) == sum(
        1 for w in wall if w["name"] != "queued")
    (dev,) = [e for e in slices if e["tid"] == 1]
    assert dev["ts"] == pytest.approx(1.0) and dev["dur"] == pytest.approx(
        2.0)
    queued = [e for e in events if e.get("cat") == "queue"]
    assert len(queued) == 2 * sum(1 for w in wall if w["name"] == "queued")
    assert min(e["ts"] for e in events if "ts" in e) == 0


def test_cli_obs_wall(capsys, tmp_path):
    from repro_torch.launch import serve as launch_serve

    out = tmp_path / "wall.json"
    launch_serve.main(["--arch", "yi-6b", "--reduced", "--requests", "3",
                       "--max-new-tokens", "3", "--max-batch", "2",
                       "--device", "cpu", "--obs", "--obs-wall", str(out)])
    text = capsys.readouterr().out
    assert "-- wall clock" in text and "queue wait: p50" in text
    assert "device idle" not in text  # no device intervals off the card
    events = json.loads(out.read_text())["traceEvents"]
    assert {e["name"] for e in events if e["ph"] == "X"} >= {
        "step", "wave", "admit", "prefill"}
    with pytest.raises(SystemExit):
        launch_serve.main(["--arch", "yi-6b", "--reduced", "--device",
                           "cpu", "--obs-wall", str(out)])


class _FakeEvent:
    """A CUDA timing event's stand-in whose device clock is the host's:
    a mark placed from an anchor lands on the host time it was recorded
    at."""

    def __init__(self):
        self.t = None

    def record(self, stream=None):
        import time
        self.t = time.perf_counter_ns()

    def query(self):
        return True

    def elapsed_time(self, other):
        return (other.t - self.t) / 1e6  # ms, as torch gives it


def _fake_card(obs, monkeypatch, chunk, reserve, batch):
    """Give a CPU recorder in wall mode a card's event machinery on fake
    events, from a pool of the sizes given; returns, for each event made,
    the innermost session span open then (None between steps)."""
    from repro_torch.runtime.graphs import Replayed

    made_in = []

    def make():
        stack = obs._wall_stack
        made_in.append(stack[-1]["name"] if stack else None)
        return _FakeEvent()

    obs._replayed = Replayed()
    obs._capturing = lambda: False
    obs._current_stream = lambda: None
    for name, n in (("CHUNK", chunk), ("RESERVE", reserve), ("BATCH", batch)):
        monkeypatch.setattr(pobs.spans, f"EVENT_{name}", n)
    obs._events = pobs.spans.EventPool(make=make)
    return made_in


def _sectored_step(obs, prefills=0):
    """One step's wall boundaries as the session makes them: admissions
    (six events each), then a sectored wave (merge and replay pairs), the
    token read and its anchor."""
    obs.wall_open("step")
    for rid in range(prefills):
        for name in ("prefill", "first_token", "install"):
            obs.wall_open(name, rid)
            obs.wall_close(name, rid)
    obs.wall_open("wave")
    obs.wall_open("merge")
    obs.wall_close("merge")
    obs.wall_open("replay")
    obs.wall_close("wave")  # the replay closes with it
    obs.wall_open("read")
    obs.wall_close("read", anchor=True)
    obs.wall_close("step")


def test_event_pool_grows_outside_device_spans(monkeypatch):
    """A pool drained step by step is topped up in the token read (behind
    the wave) and between steps, never in a span that enqueues device
    work; a step that takes more than the reserve makes events in place
    and counts a stall."""
    obs = FlightRecorder(wall=True)
    made_in = _fake_card(obs, monkeypatch, chunk=8, reserve=6, batch=4)
    for _ in range(60):  # five events a step: 300 from a chunk of 8
        _sectored_step(obs)
    assert len(made_in) > 300 - 8 and "read" in made_in
    assert obs._events.stalls == 0 and set(made_in) <= {"read", None}
    _sectored_step(obs, prefills=3)  # 18 events beyond a reserve of 6
    assert obs._events.stalls > 0 and "step" in made_in


def test_resolve_gives_its_events_back(monkeypatch):
    """resolve() places every mark on the host clock (here the host time
    it was recorded at, late by its anchor's own latency, so each device
    interval lies inside its host span but for that) and gives the events
    it read back to the pool, all but the last anchor; a second call
    places the marks made since."""
    import torch

    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    obs = FlightRecorder(wall=True)
    made_in = _fake_card(obs, monkeypatch, chunk=64, reserve=16, batch=16)
    for round_ in range(2):
        for _ in range(10):
            _sectored_step(obs, prefills=1)
        r = obs.resolve()
        wall = obs.wall_spans()
        assert len(obs.device_intervals) == 50 * (round_ + 1)
        for d in obs.device_intervals:
            span = wall[d["index"]]
            assert span["start"] <= d["start"] <= d["end"]
            assert d["end"] <= span["end"] + 1_000_000
        assert r["device_s"].keys() == {"prefill", "first_token", "install",
                                        "merge", "replay"}
        assert r["event_stalls"] == 0 and set(made_in) <= {"read", None}
        # 11 events a step and the last anchor's are out of the pool
        assert sum(m is not None for m in obs._marks) == 1
        assert len(obs._events._free) == len(made_in) - 1
    assert len(made_in) < 2 * 10 * 11  # the second round reused events


def test_wave_node_counts_read_zero_apart_from_none():
    """A wave that replayed a counted graph reads its nodes, a zero
    included; one that replayed no counted graph reads None, and so does
    a window with such a wave."""
    from repro_torch.runtime.graphs import Replayed

    obs = FlightRecorder(wall=True)
    obs._replayed = replayed = Replayed()
    for _ in range(2):
        obs.wall_open("step")
        obs.wall_open("wave")
        replayed.graphs += 1
        replayed.kernel += 7
        replayed.memcpy += 2
        obs.wall_close("wave")
        obs.wall_close("step")
    r = obs.resolve()
    assert (r["waves"], r["wave_kernel_nodes"], r["wave_memcpy_nodes"],
            r["wave_memset_nodes"]) == (2, 14, 4, 0)
    obs.wall_open("step")
    obs.wall_open("wave")
    obs.wall_close("wave")
    obs.wall_close("step")
    (*_, last) = [w for w in obs.wall_spans() if w["name"] == "wave"]
    assert last["attrs"]["kernel_nodes"] is None
    r = obs.resolve()
    assert r["waves"] == 3 and r["wave_memset_nodes"] is None
