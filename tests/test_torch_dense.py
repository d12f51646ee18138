"""The port's dense serving path against the JAX reference's, on the CPU.

* ``model.forward`` and ``model.prefill`` on the non-MoE uniform-attention
  reduced configs of ``tests/test_archs_smoke.py`` (parameters bridged bit
  for bit): hidden states, last-position logits and the prefilled cache;
* ``attention._attend_blocked`` against ``attend`` and the reference's
  blocked attention at S = 512 and 1024;
* dense ``ServeSession`` runs (reduced yi-6b, FIFO): greedy streams equal
  the reference's, mixed greedy / sampled streams equal it up to counted
  near ties, the same seeds reproduce every stream, greedy requests do not
  move when sampled requests share their waves, prompts of another
  1024-token bucket cannot join an in-flight wave, and a one-token request
  completes at prefill.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import f32, small_models
from _torch_port import one_torch_thread  # noqa: F401  (autouse)
from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.models import attention as jattention
from repro.models import model as jmodel
from repro.sample import SamplerSpec as JSamplerSpec
from repro.serve import AlwaysDense as JAlwaysDense
from repro.serve import Request as JRequest
from repro.serve import ServeSession as JServeSession
from repro_torch import bridge, configs
from repro_torch.launch import serve as launch_serve
from repro_torch.models import attention, model
from repro_torch.sample import SamplerSpec
from repro_torch.serve import AlwaysDense, Request, ServeSession

#: test_archs_smoke's uniform-attention archs without MoE
ARCHS = ("chatglm3-6b", "musicgen-large", "qwen2-72b", "qwen2-vl-72b",
         "qwen3-32b", "yi-6b")
# bf16 trunk after 2 layers, |h| up to ~4 (bf16 ulp 0.03 there): measured
# 0.039; logits (|l| < 1): measured 0.0059; cache rows: measured 0.031
HIDDEN_TOL = 0.0625
LOGIT_TOL = 0.02
KV_TOL = 0.0625
# blocked attention outputs (bf16, |o| < 3): vs the reference's measured
# 0.00098; vs the full form, which rounds scores and weights to bf16 where
# the blocked one rounds only p, measured 0.0156
ATTEND_TOL = 0.0625
LOGPROB_TOL = 0.02
MAX_NEW = 6


def _bridged(arch):
    jcfg = jconfigs.get(arch).reduced()
    cfg = configs.get(arch).reduced()
    jparams = jmodel.init_params(jcfg, jax.random.key(0))
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      device="cpu")
    return jcfg, cfg, jparams, params


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_prefill_match_reference(arch):
    jcfg, cfg, jparams, params = _bridged(arch)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 40)).astype(
        np.int32)
    jh = jmodel.forward(jparams, jcfg, jnp.asarray(toks))
    th = model.forward(params, cfg, torch.from_numpy(toks))
    jl, js = jax.jit(lambda t: jmodel.prefill(jparams, jcfg, t))(
        jnp.asarray(toks))
    tl, ts = model.prefill(params, cfg, torch.from_numpy(toks))
    errs = dict(hidden=float(np.abs(f32(jh) - f32(th)).max()),
                logits=float(np.abs(f32(jl) - f32(tl)).max()),
                k=float(np.abs(f32(js.kv.k) - f32(ts.kv.k)).max()),
                v=float(np.abs(f32(js.kv.v) - f32(ts.kv.v)).max()))
    print(f"{arch}: max abs err {errs}")
    assert th.shape == (2, 40, cfg.d_model) and tl.shape == (2, cfg.vocab)
    assert errs["hidden"] <= HIDDEN_TOL and errs["logits"] <= LOGIT_TOL
    assert errs["k"] <= KV_TOL and errs["v"] <= KV_TOL
    assert ts.kv.k.shape == js.kv.k.shape == (cfg.n_layers, 2, 1024,
                                              cfg.n_kv_heads, cfg.head_dim_)
    np.testing.assert_array_equal(ts.kv.length.numpy(),
                                  np.asarray(js.kv.length))
    np.testing.assert_array_equal(ts.position.numpy(),
                                  np.asarray(js.position))
    assert not ts.kv.k[:, :, 40:].any()  # the padding stays zero
    # one decode step from the prefilled state, as the smoke test does
    tok = torch.argmax(tl.float(), -1)[:, None].to(torch.int32)
    lg, ts2 = model.decode_step(params, cfg, ts, tok)
    assert torch.isfinite(lg.float()).all()
    assert ts2.position.tolist() == [41, 41]


@pytest.mark.parametrize("S", [512, 1024])
def test_attend_blocked_matches_attend_and_reference(S):
    cfg = configs.get("yi-6b").reduced(n_heads=4, n_kv_heads=2, head_dim=32)
    jcfg = jconfigs.get("yi-6b").reduced(n_heads=4, n_kv_heads=2,
                                         head_dim=32)
    rng = np.random.default_rng(S)
    shapes = dict(q=(1, S, 4, 32), k=(1, S, 2, 32), v=(1, S, 2, 32))
    j = {n: jnp.asarray(rng.normal(size=s), jnp.bfloat16)
         for n, s in shapes.items()}
    t = {n: bridge.tensor_from_numpy(np.asarray(a), device="cpu")
         for n, a in j.items()}
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (1, S))
    got = attention._attend_blocked(cfg, t["q"], t["k"], t["v"],
                                    torch.from_numpy(pos.copy()))
    want = jattention._attend_blocked(jcfg, j["q"], j["k"], j["v"],
                                      jnp.asarray(pos))
    # the full form, through attend's body with the projections skipped
    kf = attention._expand_kv(t["k"], 4)
    vf = attention._expand_kv(t["v"], 4)
    scores = torch.matmul(t["q"].transpose(1, 2),
                          kf.permute(0, 2, 3, 1)).float() / np.sqrt(32.0)
    mask = torch.tril(torch.ones(S, S, dtype=torch.bool))
    w = torch.softmax(torch.where(mask, scores, attention.NEG_INF),
                      -1).to(torch.bfloat16)
    full = torch.matmul(w, vf.transpose(1, 2)).transpose(1, 2)
    err_ref = float(np.abs(f32(got) - f32(want)).max())
    err_full = float(np.abs(f32(got) - f32(full)).max())
    print(f"blocked S={S}: vs reference {err_ref}, vs attend {err_full}")
    assert got.dtype == torch.bfloat16 and got.shape == (1, S, 4, 32)
    assert err_ref <= ATTEND_TOL and err_full <= ATTEND_TOL
    with pytest.raises(ValueError, match="S % 512"):
        attention._attend_blocked(cfg, t["q"][:, :S - 1], t["k"][:, :S - 1],
                                  t["v"][:, :S - 1],
                                  torch.from_numpy(pos[:, :S - 1].copy()))


def test_blocked_attention_config_routes_attend():
    """``cfg.blocked_attention`` sends ``attend`` (and so prefill) through
    the blocked form, as in the reference."""
    jcfg, cfg, jparams, params = small_models()
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (1, 512)).astype(
        np.int32)
    blocked = cfg.__class__(**{**cfg.__dict__, "blocked_attention": True})
    jblocked = jcfg.__class__(**{**jcfg.__dict__, "blocked_attention": True})
    tl, _ = model.prefill(params, blocked, torch.from_numpy(toks))
    jl, _ = jax.jit(lambda t: jmodel.prefill(jparams, jblocked, t))(
        jnp.asarray(toks))
    plain, _ = model.prefill(params, cfg, torch.from_numpy(toks))
    err = float(np.abs(f32(tl) - f32(jl)).max())
    print(f"blocked prefill logits vs reference: {err}")
    assert err <= LOGIT_TOL
    assert not torch.equal(tl, plain)  # the other form really ran


# -- dense serving sessions --------------------------------------------------


@pytest.fixture(scope="module")
def models():
    return small_models()


def _prompts(vocab, lengths=(40, 52, 60, 33)):
    rng = np.random.default_rng(21)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lengths]


def _specs(seed0=7):
    """Requests 0 and 2 sampled, 1 and 3 greedy (the CLI's
    ``--sample-every 2``)."""
    return [SamplerSpec(temperature=0.8, top_k=50, top_p=0.9,
                        seed=seed0 + r) if r % 2 == 0 else None
            for r in range(4)]


def _jspec(spec):
    if spec is None:
        return None
    return JSamplerSpec(temperature=spec.temperature, top_k=spec.top_k,
                        top_p=spec.top_p, seed=spec.seed)


def _run_reference(jcfg, jparams, prompts, specs, max_new=MAX_NEW):
    backend = jserve.build_backend(jcfg, jparams)
    sess = JServeSession(backend, max_batch=4, policy=JAlwaysDense())
    handles = [sess.submit(JRequest(r, p, max_new_tokens=max_new,
                                    sampler=_jspec(s)))
               for r, (p, s) in enumerate(zip(prompts, specs))]
    return handles, sess.run_until_drained()


class _Recorder:
    """Keeps every logits row the port session selected a token from,
    by request id (the prefill's first, then one per wave)."""

    def __init__(self, sess):
        self.logits: dict[int, list] = {}
        backend = sess.backend
        prefill, decode = backend.prefill_fn, backend.decode_fn

        def rec_prefill(tokens):
            logits, state = prefill(tokens)
            self._pending = logits[0].float().clone()
            return logits, state

        def rec_decode(state, token):
            logits, new = decode(state, token)
            for s in sess.active_slots():
                self.logits.setdefault(sess.slots[s].rid, []).append(
                    logits[s].float().clone())
            return logits, new

        backend.prefill_fn = rec_prefill
        backend.decode_fn = rec_decode
        prefill_one = sess.prefill_one

        def rec_prefill_one(handle):
            out = prefill_one(handle)
            self.logits.setdefault(handle.rid, []).append(self._pending)
            return out
        sess.prefill_one = rec_prefill_one


def _run_port(cfg, params, prompts, specs, max_new=MAX_NEW, record=False):
    backend = launch_serve.build_backend(cfg, params, device="cpu")
    sess = ServeSession(backend, max_batch=4, policy=AlwaysDense())
    rec = _Recorder(sess) if record else None
    handles = [sess.submit(Request(r, p, max_new_tokens=max_new, sampler=s))
               for r, (p, s) in enumerate(zip(prompts, specs))]
    stats = sess.run_until_drained()
    return handles, stats, rec, sess


def _near_tie(logits, spec, pos, got, want) -> bool:
    """Whether the port's token ``got`` and the reference's ``want`` are a
    near tie for logits that agree within LOGIT_TOL: greedy, the two
    logits within 2 * LOGIT_TOL; sampled, the two perturbed scores within
    2 * LOGIT_TOL / T, or ``want`` at the top-p boundary (its prefix mass
    within 2 * LOGIT_TOL of p)."""
    from repro_torch.sample import SamplerRows, kernel, rng
    if spec is None:
        return float(logits[got] - logits[want]) <= 2 * LOGIT_TOL
    row = SamplerRows.from_specs([spec], [pos])
    scaled = kernel._mask_top_k(logits[None] / spec.temperature, row.top_k)
    probs = torch.softmax(scaled, -1)[0]
    ahead = probs[probs > probs[want]].sum()
    if abs(float(ahead) - spec.top_p) <= 2 * LOGIT_TOL:
        return True
    z = (kernel._mask_top_p(scaled, row.top_p)
         + rng.gumbel(rng.token_key(row.seed, row.pos), logits.shape[-1]))[0]
    return float(z[got] - z[want]) <= 2 * LOGIT_TOL / spec.temperature


def _compare_streams(jh, th, rec, specs):
    """Tokens compared until a stream parts (then its fed-back inputs
    differ); every parting must be a near tie. Returns (compared, ties)."""
    compared = ties = 0
    for j, t, spec in zip(jh, th, specs):
        assert len(t.peek()) == len(j.peek()) == MAX_NEW
        for i, (a, b) in enumerate(zip(j.peek(), t.peek())):
            if a != b:
                assert _near_tie(rec.logits[t.rid][i], spec, i, b, a), \
                    (t.rid, i)
                ties += 1
                break
            compared += 1
    return compared, ties


def test_dense_greedy_streams_match_reference(models):
    jcfg, cfg, jparams, params = models
    prompts = _prompts(cfg.vocab)
    jh, jstats = _run_reference(jcfg, jparams, prompts, [None] * 4)
    th, tstats, rec, _ = _run_port(cfg, params, prompts, [None] * 4,
                                   record=True)
    compared, ties = _compare_streams(jh, th, rec, [None] * 4)
    worst = max(abs(a - b) for j, t in zip(jh, th)
                for a, b in zip(j.logprobs(), t.logprobs()))
    print(f"dense greedy: {compared} tokens equal, {ties} near ties, "
          f"logprob max err {worst}")
    assert compared >= 0.9 * 4 * MAX_NEW and worst <= LOGPROB_TOL
    for key in ("completed", "waves", "decode_steps", "prefill_calls"):
        assert tstats[key] == jstats[key], key


def test_dense_mixed_streams_match_reference(models):
    jcfg, cfg, jparams, params = models
    prompts, specs = _prompts(cfg.vocab), _specs()
    jh, _ = _run_reference(jcfg, jparams, prompts, specs)
    th, _, rec, _ = _run_port(cfg, params, prompts, specs, record=True)
    compared, ties = _compare_streams(jh, th, rec, specs)
    print(f"dense mixed: {compared} tokens equal, {ties} near ties")
    assert compared >= 0.75 * 4 * MAX_NEW
    # the sampled requests really sampled: not their greedy streams
    gh, _, _, _ = _run_port(cfg, params, prompts, [None] * 4)
    assert any(t.peek() != g.peek() for t, g in zip(th[::2], gh[::2]))


def test_dense_same_seeds_reproduce_and_greedy_is_invariant(models):
    _, cfg, _, params = models
    prompts = _prompts(cfg.vocab)
    first, _, _, s1 = _run_port(cfg, params, prompts, _specs())
    second, _, _, s2 = _run_port(cfg, params, prompts, _specs())
    for a, b in zip(first, second):
        assert a.peek() == b.peek() and a.logprobs() == b.logprobs()
    assert torch.equal(s1._sampler_rows.pos, s2._sampler_rows.pos)
    greedy, _, _, _ = _run_port(cfg, params, prompts, [None] * 4)
    for r in (1, 3):  # greedy requests with sampled co-residents
        assert first[r].peek() == greedy[r].peek()
        assert first[r].logprobs() == greedy[r].logprobs()
    # every wave of the mixed session ran the sampled flavor
    assert {key[1] for key in s1._wave_cache} == {True}


def test_fifo_mixed_buckets_raise(models):
    """A prompt whose cache pads to another 1024-token bucket cannot join
    an in-flight dense wave under FIFO (the reference's ValueError), and
    rebuilds the buffer once no slot is active."""
    _, cfg, _, params = models
    backend = launch_serve.build_backend(cfg, params, device="cpu")
    sess = ServeSession(backend, max_batch=4)
    rng = np.random.default_rng(5)
    sess.submit(Request(0, rng.integers(0, cfg.vocab, 10).astype(np.int32),
                        max_new_tokens=4))
    sess.step()
    long = rng.integers(0, cfg.vocab, 1020).astype(np.int32)
    sess.submit(Request(1, long, max_new_tokens=2))
    with pytest.raises(ValueError, match="cannot join the in-flight wave"):
        sess.step()
    assert sess.batched.kv.k.shape[2] == 1024  # untouched by the refusal

    fresh = ServeSession(backend, max_batch=4)
    short = fresh.submit(Request(0, long[:10], max_new_tokens=2))
    fresh.run_until_drained()
    handle = fresh.submit(Request(1, long, max_new_tokens=2))
    fresh.run_until_drained()
    assert short.done and handle.done and len(handle.peek()) == 2
    assert fresh.batched.kv.k.shape[2] == 2048
    assert not sess.wave_accepts(fresh._batched_sig)
    assert sess.wave_accepts(sess._batched_sig)


def test_one_token_request_completes_at_prefill(models):
    jcfg, cfg, jparams, params = models
    prompts, specs = _prompts(cfg.vocab)[:3], _specs()[:3]
    jh, jstats = _run_reference(jcfg, jparams, prompts, specs, max_new=1)
    th, tstats, _, _ = _run_port(cfg, params, prompts, specs, max_new=1)
    assert tstats["waves"] == jstats["waves"] == 0
    assert tstats["completed"] == 3
    for j, t in zip(jh, th):
        assert t.done and len(t.peek()) == 1 and t.peek() == j.peek()
