"""The port's ServeSession vs the JAX reference's, end to end on the CPU.

Both sessions serve the same requests (multi-page prompts, one duplicate
prompt so the demand merge pools two slots) with FIFO admission, an
always-sectored policy and the same page budget: the reference with its
``dispatch`` attend, the port with its ``fused`` attend (the kernel's
plain version on the CPU). Greedy streams must be equal; a stream may
only part where the port's own top-2 logit margin is inside the logit
tolerance (a near tie that rounding can flip). Logprobs agree within
tolerance and the session stats are equal.
"""

import numpy as np
import pytest
import torch

from _torch_port import small_models
from _torch_port import one_torch_thread  # noqa: F401  (autouse)
from repro.runtime import sectored_decode as jsd
from repro import serve as jserve
from repro.launch import serve as jlaunch_serve
from repro.sample import SamplerSpec as JSamplerSpec
from repro.serve import AlwaysSectored as JAlwaysSectored
from repro.serve import Request as JRequest
from repro.serve import ServeSession as JServeSession
from repro_torch import serve as pserve
from repro_torch.launch import serve as launch_serve
from repro_torch.obs import FlightRecorder
from repro_torch.runtime import sectored_decode
from repro_torch.sample import SamplerSpec
from repro_torch.serve import (AlwaysSectored, Engine, EngineConfig,
                               FifoScheduler, KVPagePool, LoopedEngine,
                               OverlapScheduler, PrefixCache, Request,
                               ServeSession, ServingBackend)
from repro_torch.telemetry import MeteredBackend

SEQ_LEN = 384  # 8 padded pages
PROMPT = 260  # 3 valid pages; k=1 + probe reads 2 of them
MAX_NEW = 6
# bf16 logits of the reduced model (see test_torch_sectored_decode:
# measured 0.0051 there); a top-2 margin above this cannot flip
LOGIT_TOL = 0.02
# raw f32 logprobs from those logits; measured max-abs-err 0.0035
LOGPROB_TOL = 0.02


@pytest.fixture(scope="module")
def models():
    return small_models()


def _prompts(vocab):
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, vocab, PROMPT).astype(np.int32)
               for _ in range(4)]
    # requests 1 and 2 share their prompt and are admitted together
    return prompts[:2] + [prompts[1].copy()] + prompts[2:]


class _Recorder:
    """Wraps the port backend's steps to keep every logits row the
    session selected a token from, keyed by request id."""

    def __init__(self, session):
        self.session = session
        self.logits: dict[int, list] = {}
        backend = session.backend
        prefill, step_for = backend.prefill_fn, backend.sectored_fn_for
        self._wrapped = {}

        def rec_prefill(tokens):
            logits, state = prefill(tokens)
            self._pending_prefill = logits[0]
            return logits, state

        def rec_step_for(frac):
            fn = step_for(frac)
            if id(fn) not in self._wrapped:
                def rec(state, token):
                    logits, new = fn(state, token)
                    for s in session.active_slots():
                        self.logits.setdefault(session.slots[s].rid,
                                               []).append(logits[s])
                    return logits, new
                self._wrapped[id(fn)] = rec
            return self._wrapped[id(fn)]

        backend.prefill_fn = rec_prefill
        backend.sectored_fn_for = rec_step_for
        orig_prefill_one = session.prefill_one

        def prefill_one(handle):
            out = orig_prefill_one(handle)
            self.logits.setdefault(handle.rid, []).append(
                self._pending_prefill)
            return out
        session.prefill_one = prefill_one

    def margin(self, rid, i) -> float:
        top = torch.topk(self.logits[rid][i].float(), 2).values
        return float(top[0] - top[1])


def _run_reference(jcfg, jparams, prompts, stop=()):
    backend = jsd.make_serving_fns(jcfg, params=jparams, seq_len=SEQ_LEN,
                                   min_topk=1, kernel="dispatch")
    sess = JServeSession(backend, max_batch=4, policy=JAlwaysSectored())
    handles = [sess.submit(JRequest(rid, p, max_new_tokens=MAX_NEW,
                                    stop_tokens=stop))
               for rid, p in enumerate(prompts)]
    stats = sess.run_until_drained()
    return handles, stats


def _run_port(cfg, params, prompts, stop=()):
    backend = sectored_decode.make_serving_fns(
        cfg, params=params, seq_len=SEQ_LEN, min_topk=1, kernel="fused",
        device="cpu")
    sess = ServeSession(backend, max_batch=4, policy=AlwaysSectored())
    recorder = _Recorder(sess)
    handles = [sess.submit(Request(rid, p, max_new_tokens=MAX_NEW,
                                   stop_tokens=stop))
               for rid, p in enumerate(prompts)]
    stats = sess.run_until_drained()
    return handles, stats, recorder


@pytest.fixture(scope="module")
def served(models):
    jcfg, cfg, jparams, params = models
    prompts = _prompts(cfg.vocab)
    jh, jstats = _run_reference(jcfg, jparams, prompts)
    th, tstats, rec = _run_port(cfg, params, prompts)
    return jh, jstats, th, tstats, rec


def test_greedy_streams_match_reference(served):
    jh, _, th, _, rec = served
    compared = 0
    for j, t in zip(jh, th):
        want, got = j.peek(), t.peek()
        assert len(got) == len(want) == MAX_NEW
        for i, (a, b) in enumerate(zip(want, got)):
            if a != b:
                # only a near tie may part the streams, and then the rest
                # of this stream is no longer comparable
                assert rec.margin(t.rid, i) < LOGIT_TOL, (t.rid, i)
                break
            compared += 1
    # not vacuous: this run compared all 30 tokens (its smallest top-2
    # margin was 0.0059, and that step agreed too)
    assert compared >= 0.9 * sum(len(h.peek()) for h in jh)


def test_logprobs_within_tolerance(served):
    jh, _, th, _, _ = served
    worst = max(abs(a - b) for j, t in zip(jh, th)
                for a, b in zip(j.logprobs(), t.logprobs()))
    assert worst <= LOGPROB_TOL, worst


def test_stats_match_reference(served):
    _, jstats, th, tstats, _ = served
    for key in ("completed", "waves", "sectored_steps", "decode_steps",
                "sectored_waves", "merged_slots", "prefill_calls"):
        assert tstats[key] == jstats[key], key
    assert tstats["merged_slots"] > 0  # the duplicate prompt merged
    # identical prompts, identical greedy streams
    assert th[1].peek() == th[2].peek()


def test_stop_token_contract(models, served):
    """A stop token ends the stream at its first emission (the token is
    emitted, nothing after it), the same way in both stacks."""
    jcfg, cfg, jparams, params = models
    _, _, th, _, _ = served
    stop = (th[0].peek()[2],)
    prompts = _prompts(cfg.vocab)[:2]
    jh, jstats = _run_reference(jcfg, jparams, prompts, stop=stop)
    ph, pstats, _ = _run_port(cfg, params, prompts, stop=stop)
    assert ph[0].stopped and ph[0].peek() == th[0].peek()[:3]
    for j, t in zip(jh, ph):
        assert t.peek() == j.peek() and t.stopped == j.stopped
    assert pstats["eos_stops"] == jstats["eos_stops"] >= 1
    assert pstats["completed"] == jstats["completed"] == 2


def test_session_rejects_what_is_not_ported(models):
    _, cfg, _, params = models
    backend = sectored_decode.make_serving_fns(cfg, params=params,
                                               seq_len=SEQ_LEN, device="cpu")
    # everything is ported: a mesh backend's hooks are discovered (the
    # pre-fused ablation is refused over one, as in the reference); the
    # pool, the prefix cache, the flight recorder and the looped and
    # pre-fused waves are accepted
    mesh = sectored_decode.make_serving_fns(cfg, params=params,
                                            seq_len=SEQ_LEN, device="cpu")
    mesh.wave_for = lambda fn, sampled=False: None
    assert ServeSession(mesh)._backend_wave_for is mesh.wave_for
    with pytest.raises(ValueError, match="fuse_wave"):
        ServeSession(mesh, fuse_wave=False)
    for kwargs in (dict(page_pool=KVPagePool(8)),
                   dict(prefix_cache=PrefixCache(8)),
                   dict(obs=FlightRecorder()), dict(vectorized=False),
                   dict(fuse_wave=False)):
        ServeSession(backend, **kwargs)
    # a metered backend is ported: the session discovers its meter
    metered = ServeSession(MeteredBackend(backend))
    assert metered.meter is not None and metered.backend.inner is backend
    sess = ServeSession(backend)
    assert sess.meter is None
    # sampling is ported: a sampled request is served, its first token
    # drawn at counter 0 and each wave's at the next
    sampled = sess.submit(Request(0, np.arange(4, dtype=np.int32), 3,
                                  sampler=SamplerSpec(temperature=0.8,
                                                      seed=5)))
    assert sampled.result() and len(sampled.peek()) == 3
    assert sess._sampler_rows.pos[0] == 3
    assert list(sess._wave_cache) == [(id(backend.decode_fn), True)]
    for bad in (dict(prompt=np.zeros(0, np.int32)), dict(max_new_tokens=0),
                dict(stop_tokens=(cfg.vocab,)),
                dict(stop_tokens=tuple(range(9)))):
        req = dict(rid=1, prompt=np.arange(4, dtype=np.int32),
                   max_new_tokens=2) | bad
        with pytest.raises(ValueError):
            sess.submit(Request(**req))


def test_cli_runs_on_cpu(capsys):
    stats = launch_serve.main(["--arch", "yi-6b", "--reduced",
                               "--requests", "3", "--max-new-tokens", "3",
                               "--max-batch", "2", "--true-sectored",
                               "--fused-kernel", "--policy", "sectored",
                               "--device", "cpu"])
    assert stats["completed"] == 3 and stats["sectored_steps"] > 0
    assert "kernel=fused" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        launch_serve.main(["--arch", "yi-6b", "--kv-quant", "--device",
                           "cpu"])
    with pytest.raises(SystemExit):
        launch_serve.main(["--arch", "yi-6b", "--fused-kernel", "--device",
                           "cpu"])


@pytest.mark.parametrize("extra", [
    [], ["--temperature", "0.8", "--top-p", "0.9", "--seed", "3",
         "--sample-every", "2"],
    ["--true-sectored", "--fused-kernel", "--policy", "sectored",
     "--temperature", "0.8", "--top-k", "50", "--seed", "3",
     "--sample-every", "2"]], ids=["dense", "dense_sampled",
                                   "fused_sampled"])
def test_cli_dense_and_sampled_on_cpu(capsys, extra):
    stats = launch_serve.main(["--arch", "yi-6b", "--reduced",
                               "--requests", "3", "--max-new-tokens", "3",
                               "--device", "cpu", *extra])
    assert stats["completed"] == 3 and stats["decode_steps"] == 6
    out = capsys.readouterr().out
    if "--temperature" in extra:
        assert "rid=  0 sampler=T=0.8" in out and "rid=  1 sampler=greedy" \
            in out
    with pytest.raises(SystemExit):  # a filter without a temperature
        launch_serve.main(["--arch", "yi-6b", "--top-p", "0.9",
                           "--device", "cpu"])


# -- overlap scheduling, paged admission, wave flavors, engine shims ----------


def _mixed_run(stack, backend, scheduler, spec_cls, **flavor):
    """The reference's fifo == overlap sampling trace: 5 requests, odd
    ones sampled, 2 slots, the sectored top-k path with the OR-merge."""
    sess = stack.ServeSession(backend, max_batch=2, scheduler=scheduler,
                              policy=stack.HysteresisPolicy(
                                  min_occupancy=0.5), **flavor)
    rng = np.random.default_rng(5)
    handles = []
    for rid in range(5):
        prompt = rng.integers(0, 128, size=6).astype(np.int32)
        spec = (spec_cls(temperature=0.9, top_p=0.95, seed=40 + rid)
                if rid % 2 else None)
        handles.append(sess.submit(stack.Request(rid, prompt,
                                                 max_new_tokens=4,
                                                 sampler=spec)))
    stats = sess.run_until_drained()
    assert stats["sectored_waves"] > 0
    return {h.rid: h.peek() for h in handles}, dict(stats)


def test_overlap_matches_fifo_and_reference(models):
    """fifo == overlap in the port (every wave flavor), and both equal the
    reference's streams and stats on the same trace; overlap prefills
    under in-flight waves in fewer prefill calls."""
    jcfg, cfg, jparams, params = models
    port = sectored_decode.make_serving_fns(cfg, params=params, seq_len=48,
                                            device="cpu")
    ref = jsd.make_serving_fns(jcfg, params=jparams, seq_len=48)
    fifo, fstats = _mixed_run(pserve, port, FifoScheduler(),
                              SamplerSpec)
    for flavor in (dict(), dict(vectorized=False), dict(fuse_wave=False)):
        assert _mixed_run(pserve, port, FifoScheduler(), SamplerSpec,
                          **flavor)[0] == fifo
        toks, ostats = _mixed_run(pserve, port, OverlapScheduler(),
                                  SamplerSpec, **flavor)
        assert toks == fifo
    assert ostats["overlapped_prefills"] >= 1
    assert fstats["overlapped_prefills"] == 0
    assert ostats["prefill_calls"] < fstats["prefill_calls"]
    jfifo, jfstats = _mixed_run(jserve, ref, jserve.FifoScheduler(),
                                JSamplerSpec)
    jov, jostats = _mixed_run(jserve, ref, jserve.OverlapScheduler(),
                              JSamplerSpec)
    assert (fifo, fstats) == (jfifo, jfstats)
    assert (toks, ostats) == (jov, jostats)


def _quantum_backend(quantum=4, vocab=32):
    """A toy backend whose state width is the prompt length rounded up to
    ``quantum`` (a stand-in for page-padded KV)."""
    from _torch_port import SumState

    def prefill_fn(tokens):
        tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.int32)
        B, S = tokens.shape
        s = tokens.sum(dim=1).to(torch.int32)
        q = quantum * ((S + quantum - 1) // quantum)
        logits = torch.nn.functional.one_hot(s.long() % vocab, vocab)
        return logits.float(), SumState(s, torch.zeros((B, q)))

    def decode_fn(state, token):
        logits = torch.nn.functional.one_hot(
            (token[:, 0].long() + 1) % vocab, vocab)
        return logits.float(), SumState(state.s + 1, state.kv)

    return ServingBackend(prefill_fn, decode_fn, device="cpu")


def test_paged_admission_by_signature():
    """Same quantum shares a wave; another quantum is prefilled, parked
    and admitted once the wave drains (head of line, never starved);
    FIFO has no paged admission and raises."""
    sess = ServeSession(_quantum_backend(), max_batch=4,
                        scheduler=OverlapScheduler())
    for rid, n in enumerate((3, 4, 6)):
        sess.submit(Request(rid, np.arange(n, dtype=np.int32),
                            max_new_tokens=3))
    sess.step()
    assert sess.active_slots() == [0, 1] and sess.scheduler.pending() == 1
    sess.run_until_drained()
    assert sess.completion_order == [0, 1, 2]
    steady = ServeSession(_quantum_backend(), max_batch=2,
                          scheduler=OverlapScheduler())
    for rid in range(2):
        steady.submit(Request(rid, np.arange(3, dtype=np.int32),
                              max_new_tokens=6))
    steady.step()
    parked = steady.submit(Request(100, np.arange(6, dtype=np.int32),
                                   max_new_tokens=3))
    for i in range(40):
        steady.submit(Request(200 + i, np.arange(3, dtype=np.int32),
                              max_new_tokens=2))
        steady.step()
        if parked.done:
            break
    assert parked.done
    fifo = ServeSession(_quantum_backend(), max_batch=4)
    fifo.submit(Request(0, np.arange(3, dtype=np.int32), max_new_tokens=4))
    fifo.step()
    fifo.submit(Request(1, np.arange(6, dtype=np.int32), max_new_tokens=4))
    with pytest.raises(ValueError, match="cannot join the in-flight wave"):
        fifo.step()
    group = ServeSession(_quantum_backend(), max_batch=2,
                         scheduler=OverlapScheduler())
    handles = [group.submit(Request(r, np.arange(3, dtype=np.int32),
                                    max_new_tokens=1)) for r in range(3)]
    group.run_until_drained()
    assert all(len(h.peek()) == 1 and h.done for h in handles)


def test_engine_shims_looped_equals_vectorized(models):
    """The legacy shims mutate the Request in place; the looped engine's
    streams equal the vectorized engine's on the sectored backend (top-k
    path and OR-merge on), and an engine's config is its own."""
    _, cfg, _, params = models
    backend = sectored_decode.make_serving_fns(cfg, params=params,
                                               seq_len=48, device="cpu")
    fns = (backend.prefill_fn, backend.decode_fn, backend.sectored_fn)
    streams = []
    for cls in (Engine, LoopedEngine):
        engine = cls(*fns, EngineConfig(max_batch=2),
                     demand_merge_fn=backend.demand_merge_fn, device="cpu")
        shared = np.arange(6, dtype=np.int32)
        reqs = [Request(rid, shared.copy() if rid < 2 else
                        np.arange(rid, rid + 6, dtype=np.int32),
                        max_new_tokens=4) for rid in range(4)]
        for r in reqs:
            engine.submit(r)
        stats = engine.run_until_drained()
        assert all(r.done and len(r.generated) == 4 for r in reqs)
        assert stats["sectored_waves"] > 0 and stats["merged_slots"] > 0
        streams.append([list(r.generated) for r in reqs])
    assert streams[0] == streams[1]
    assert streams[0][0] == streams[0][1]  # identical prompts
    f = LoopedEngine(*fns, EngineConfig(max_batch=2), device="cpu")
    g = Engine(*fns, device="cpu")
    assert f.cfg is not g.cfg and g.cfg.max_batch == 8
    assert f.states == [None, None] and g.batched is None


_CLI_KEYS = ("completed", "decode_steps", "waves", "sectored_steps",
             "merged_slots", "overlapped_prefills", "eos_stops",
             "preemptions", "kv_peak_pages", "prefix_hits",
             "prefix_hit_tokens", "shared_pages_held", "cow_copies",
             "prefix_evictions")


def _summary(out: str) -> dict:
    line = next(ln for ln in out.splitlines() if ln.startswith("arch="))
    pairs = dict(tok.split("=", 1) for tok in line.split() if "=" in tok)
    return {k: pairs[k] for k in _CLI_KEYS}


@pytest.mark.parametrize("engine", ["vectorized", "looped"])
def test_cli_serving_layer_flags_match_reference(capsys, tmp_path, engine):
    """The CLI's pool, prefix-cache, overlap and recorder flags: the
    summary line's counters equal the reference CLI's on the same flags
    (they depend on prompt lengths and scheduling, not on the weights,
    which each stack draws from its own generator); the exports exist."""
    flags = ["--arch", "yi-6b", "--reduced", "--requests", "5",
             "--max-new-tokens", "6", "--max-batch", "2",
             "--true-sectored", "--policy", "sectored",
             "--scheduler", "overlap", "--kv-pages", "6",
             "--kv-page-size", "16", "--prefix-cache", "--shared-prefix",
             "32", "--engine", engine, "--obs"]
    jlaunch_serve.main(flags)
    want = _summary(capsys.readouterr().out)
    trace, perfetto = tmp_path / "t.jsonl", tmp_path / "t.json"
    stats = launch_serve.main([*flags, "--telemetry", "--obs-commands",
                               "--obs-trace-out", str(trace),
                               "--obs-perfetto-out", str(perfetto),
                               "--device", "cpu"])
    out = capsys.readouterr().out
    assert _summary(out) == want
    assert stats["completed"] == 5 and stats["preemptions"] > 0
    assert "-- flight recorder" in out and "prefix reuse:" in out
    assert trace.exists() and perfetto.exists()
    assert (tmp_path / "t.jsonl.commands.jsonl").exists()


@pytest.mark.parametrize("bad", [
    ["--prefix-cache"], ["--true-sectored", "--shared-prefix", "4"],
    ["--kv-page-size", "16"], ["--obs-trace-out", "x"],
    ["--obs", "--obs-commands"]],
    ids=["cache_without_sectored", "shared_without_cache",
         "page_size_without_pool", "trace_without_obs",
         "commands_without_telemetry"])
def test_cli_refuses_what_the_reference_refuses(bad):
    with pytest.raises(SystemExit):
        launch_serve.main(["--arch", "yi-6b", "--reduced", "--device", "cpu",
                           *bad])
    with pytest.raises(SystemExit):
        jlaunch_serve.main(["--arch", "yi-6b", "--reduced", *bad])
