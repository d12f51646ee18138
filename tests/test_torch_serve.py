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
from repro.serve import AlwaysSectored as JAlwaysSectored
from repro.serve import Request as JRequest
from repro.serve import ServeSession as JServeSession
from repro_torch.launch import serve as launch_serve
from repro_torch.runtime import sectored_decode
from repro_torch.sample import SamplerSpec
from repro_torch.serve import AlwaysSectored, Request, ServeSession
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
    for kwargs in (dict(page_pool=object()), dict(prefix_cache=object()),
                   dict(obs=object()), dict(vectorized=False),
                   dict(fuse_wave=False)):
        with pytest.raises(NotImplementedError):
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
