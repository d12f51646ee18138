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
