"""The port's MoE layer (``repro_torch.models.moe``) and the MoE branch of
the model and of sectored decode, against the JAX reference on reduced
configs with the reference's parameters bridged bit for bit.

* ``moe_ffn``: the routing (top-k expert indices) and the kept/dropped
  mask of every assignment equal the reference's exactly; outputs within
  ``LOGIT_TOL``. ``torch.topk`` and ``jax.lax.top_k`` may break an exact
  tie in the f32 router logits differently; the random inputs here have
  none, so the indices are compared exactly.
* a router forced so that two of four tokens share their experts under
  ``cap`` = 1: the port drops exactly the reference's assignments, and
  the shared token's output at batch 4 differs from its output alone in
  both stacks (capacity makes a wave's output depend on its batch; this
  is the reference's semantics).
* the model (dense path) and sectored decode of the reduced qwen3-moe:
  page selections equal, logits within ``LOGIT_TOL``, greedy tokens
  equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import f32
from _torch_port import one_torch_thread  # noqa: F401  (autouse)
from repro import configs as jconfigs
from repro.configs.base import MoEConfig as JMoEConfig
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.runtime import sector_predictor as jsp
from repro.runtime import sectored_decode as jsd
from repro_torch import bridge, configs
from repro_torch.configs import MoEConfig
from repro_torch.models import attention, model, moe
from repro_torch.runtime import sector_predictor, sectored_decode

ARCHS = ("qwen3-moe-235b-a22b", "kimi-k2-1t-a32b")
# bf16 MoE outputs and logits of size ~1-4 (bf16 ulp <= 0.0156): measured
# 0.0 for moe_ffn alone (the same bf16 products and the same sequential
# combine on the CPU), 0.0078 for logits after 2 layers
LOGIT_TOL = 0.02
# bf16 K/V rows of layer 1, from hidden states one bf16 rounding apart
KV_TOL = 0.0625
PAGE = sectored_decode.PAGE_SIZE
SEQ_LEN = 384  # 8 padded pages
PROMPT = 260  # 3 valid pages; k=1 + probe selects 2 of them
K_PAGES = 1


def _bridged(arch, **overrides):
    jcfg = jconfigs.get(arch).reduced(**{
        k: JMoEConfig(**vars(v)) if k == "moe" else v
        for k, v in overrides.items()})
    cfg = configs.get(arch).reduced(**overrides)
    jparams = jmodel.init_params(jcfg, jax.random.key(0))
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      device="cpu")
    return jcfg, cfg, jparams, params


@pytest.fixture(scope="module", params=ARCHS)
def bridged(request):
    return _bridged(request.param)


def _ref_routing(lp, jcfg, x):
    """The reference's routing and capacity mask for x (T, D), written
    out from ``repro.models.moe.moe_ffn`` (which does not return them):
    (idx (T, k), keep of the (token, k) assignments in token order)."""
    e = jcfg.moe
    T = x.shape[0]
    logits = jnp.einsum("td,de->te", x.astype(jnp.float32), lp["router"])
    _, idx = jax.lax.top_k(logits, e.top_k)
    flat = idx.reshape(-1)
    order = jnp.argsort(flat)
    sorted_expert = flat[order]
    cap = int(T * e.top_k * jmoe.CAPACITY_FACTOR / e.n_experts) + 1
    pos = jnp.arange(T * e.top_k) - jnp.searchsorted(
        sorted_expert, jnp.arange(e.n_experts))[sorted_expert]
    keep = np.zeros(T * e.top_k, bool)
    keep[np.asarray(order)] = np.asarray(pos < cap)
    return np.asarray(idx), keep


def _port_routing(lp, cfg, x):
    _, idx = moe.route(lp, cfg, x)
    order, _, keep, _, _ = moe.dispatch(idx, cfg)
    token_keep = torch.empty_like(keep)
    token_keep[order] = keep
    return idx.numpy(), token_keep.numpy()


def _layer0(jparams, params):
    jlp = jax.tree.map(lambda t: t[0], jparams["layers"]["moe"])
    return jlp, model.layer_params(params, 0)["moe"]


def assert_greedy_agrees(tl, jl):
    """The port's and the reference's argmax tokens are equal, except
    where the reference's two logits lie within 2 * LOGIT_TOL (a near
    tie, which the bf16 rounding differences may flip)."""
    t, j = f32(tl), f32(jl)
    got, want = t.argmax(-1), j.argmax(-1)
    for row in np.flatnonzero(got != want):
        gap = j[row, want[row]] - j[row, got[row]]
        assert gap <= 2 * LOGIT_TOL, (row, got[row], want[row], gap)
    return int((got != want).sum())


def _pair(rng, shape):
    j = jnp.asarray(rng.normal(size=shape), jnp.bfloat16)
    return j, bridge.tensor_from_numpy(np.asarray(j), device="cpu")


@pytest.mark.parametrize("T", [1, 4, 9])
def test_moe_ffn_matches_reference(bridged, T):
    jcfg, cfg, jparams, params = bridged
    jlp, lp = _layer0(jparams, params)
    jx, x = _pair(np.random.default_rng(T), (1, T, cfg.d_model))
    want_idx, want_keep = _ref_routing(jlp, jcfg, jx[0])
    got_idx, got_keep = _port_routing(lp, cfg, x[0])
    np.testing.assert_array_equal(got_idx, want_idx)
    np.testing.assert_array_equal(got_keep, want_keep)
    out = moe.moe_ffn(lp, cfg, x)
    want = jmoe.moe_ffn(jlp, jcfg, jx)
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
    np.testing.assert_allclose(f32(out), f32(want), atol=LOGIT_TOL)
    if cfg.moe.n_shared_experts:
        assert "shared" in lp


def test_bridge_carries_stacked_expert_leaves(bridged):
    jcfg, cfg, jparams, params = bridged
    e = cfg.moe
    w = params["layers"]["moe"]["w_gate"]
    assert w.shape == (cfg.n_layers, e.n_experts, cfg.d_model, e.d_expert)
    np.testing.assert_array_equal(
        bridge.tensor_to_numpy_bits(w),
        np.asarray(jparams["layers"]["moe"]["w_gate"]).view(np.uint16))
    assert params["layers"]["moe"]["router"].dtype == torch.float32


def test_capacity_drops_the_reference_assignments():
    """16 experts, top-2, T = 4: cap = 1. Tokens 0 and 2 are the same
    row, so they pick the same two experts, and the stable sort keeps
    token 0's assignments and drops token 2's."""
    jcfg, cfg, jparams, params = _bridged(
        "qwen3-moe-235b-a22b",
        moe=MoEConfig(n_experts=16, top_k=2, d_expert=64))
    assert moe.capacity(4, cfg) == 1
    jlp, lp = _layer0(jparams, params)
    rng = np.random.default_rng(7)
    rows = rng.normal(size=(4, cfg.d_model))
    rows[2] = rows[0]
    jx = jnp.asarray(rows[None], jnp.bfloat16)
    x = bridge.tensor_from_numpy(np.asarray(jx), device="cpu")
    want_idx, want_keep = _ref_routing(jlp, jcfg, jx[0])
    got_idx, got_keep = _port_routing(lp, cfg, x[0])
    np.testing.assert_array_equal(got_idx, want_idx)
    np.testing.assert_array_equal(got_keep, want_keep)
    keep = got_keep.reshape(4, 2)
    assert keep[0].all() and not keep[2].any()
    out = moe.moe_ffn(lp, cfg, x)
    jout = jmoe.moe_ffn(jlp, jcfg, jx)
    np.testing.assert_allclose(f32(out), f32(jout), atol=LOGIT_TOL)
    # token 2 lost both experts: nothing but the residual path is left
    assert not out[0, 2].any() and not np.asarray(jout[0, 2]).any()
    # alone, token 2 keeps its experts: batch 4 differs from batch 1 in
    # both stacks, and the batch-1 outputs agree
    alone = moe.moe_ffn(lp, cfg, x[:, 2:3])
    jalone = jmoe.moe_ffn(jlp, jcfg, jx[:, 2:3])
    assert alone.abs().max() > 0 and np.abs(f32(jalone)).max() > 0
    np.testing.assert_allclose(f32(alone), f32(jalone), atol=LOGIT_TOL)
    assert not torch.equal(alone[0, 0], out[0, 2])


def test_moe_chain_and_prefill_match_reference(bridged):
    """The dense path: ``prefill`` (logits and K/V rows) and a
    teacher-forced ``decode_step`` chain of the reduced MoE config. (A
    prefill's state is not its chain's: the prompt's B*S tokens share
    one capacity, the chain's B tokens another, as in the reference.)"""
    jcfg, cfg, jparams, params = bridged
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    jl, jpre = jmodel.prefill(jparams, jcfg, jnp.asarray(toks))
    tl, tpre = model.prefill(params, cfg, torch.from_numpy(toks))
    np.testing.assert_allclose(f32(tl), f32(jl), atol=LOGIT_TOL)
    np.testing.assert_allclose(f32(tpre.kv.k), f32(jpre.kv.k), atol=KV_TOL)
    np.testing.assert_allclose(f32(tpre.kv.v), f32(jpre.kv.v), atol=KV_TOL)
    np.testing.assert_array_equal(tpre.kv.length.numpy(),
                                  np.asarray(jpre.kv.length))
    jstate = jmodel.init_decode_state(jcfg, 2, 40)
    state = model.init_decode_state(cfg, 2, 40, device="cpu")
    step = jax.jit(lambda s, t: jmodel.decode_step(jparams, jcfg, s, t))
    for i in range(toks.shape[1]):
        jl, jstate = step(jstate, jnp.asarray(toks[:, i:i + 1]))
        tl, state = model.decode_step(params, cfg, state,
                                      torch.from_numpy(toks[:, i:i + 1]))
        np.testing.assert_allclose(f32(tl), f32(jl), atol=LOGIT_TOL)
        assert_greedy_agrees(tl, jl)
    np.testing.assert_array_equal(state.position.numpy(),
                                  np.asarray(jstate.position))


@pytest.fixture(scope="module")
def sectored_prefilled():
    """Both stacks' SectoredState over one synthetic three-page prompt
    (N(0, 1) K/V, a random table over the valid pages), bridged bit for
    bit: a prompt prefilled by both would route its ~1,000 (token, layer)
    pairs through near ties of the f32 router logits, and a flipped
    expert moves a K/V row by O(1)."""
    jcfg, cfg, jparams, params = _bridged("qwen3-moe-235b-a22b")
    rng = np.random.default_rng(0)
    jstate = jsd.init_state(jcfg, 2, SEQ_LEN)
    kv_shape = jstate.kv.k.shape  # (L, B, Spad, Hkv, hd)
    live = (np.arange(kv_shape[2]) < PROMPT)[None, None, :, None, None]
    k, v = (jnp.asarray(rng.normal(size=kv_shape) * live, jnp.bfloat16)
            for _ in range(2))
    P = jstate.table.shape[-1]
    table = rng.random(jstate.table.shape) * (
        np.arange(P) < (PROMPT - 1) // PAGE + 1)
    jstate = dataclasses.replace(
        jstate, kv=dataclasses.replace(
            jstate.kv, k=k, v=v,
            length=jnp.full(jstate.kv.length.shape, PROMPT, jnp.int32)),
        table=jnp.asarray(table, jnp.float32),
        position=jnp.full((2,), PROMPT, jnp.int32))
    t = [bridge.tensor_from_numpy(np.asarray(x), device="cpu")
         for x in (k, v, jstate.kv.length, jstate.table, jstate.position)]
    tstate = sectored_decode.SectoredState(
        kv=attention.KVCache(k=t[0], v=t[1], length=t[2]), table=t[3],
        position=t[4])
    toks = rng.integers(0, cfg.vocab, (2, 8)).astype(np.int32)
    return jcfg, cfg, jparams, params, jstate, tstate, toks


def _selections(state, to, predictor):
    """Per-layer page selections a narrow step with the probe makes."""
    table, length = np.asarray(state.table), np.asarray(state.kv.length)
    return np.stack([np.asarray(predictor.predict_topk(
        to(table[i]), to(length[i]), PAGE, K_PAGES + 1,
        probe_page=predictor.probe_page_for(to(length[i]), PAGE)))
        for i in range(table.shape[0])])


def test_sectored_moe_steps_match_reference(sectored_prefilled):
    """Narrow sectored steps with the probe page (dispatch, the
    reference's bitwise target; the port's fused plain version equals it
    bitwise): page selections equal, logits within LOGIT_TOL, greedy
    tokens equal."""
    jcfg, cfg, jparams, params, jstate, tstate, toks = sectored_prefilled
    tstate = tstate.clone()
    jnarrow = jax.jit(lambda s, t: jsd.sectored_decode_step(
        jparams, jcfg, s, t, K_PAGES, probe=True, kernel="dispatch"))
    worst = 0.0
    for i in range(6):
        np.testing.assert_array_equal(_selections(tstate, torch.from_numpy,
                                                  sector_predictor),
                                      _selections(jstate, jnp.asarray, jsp))
        tok = toks[:, i:i + 1]
        jl, jstate = jnarrow(jstate, jnp.asarray(tok))
        before = tstate.clone()
        tl, tstate = sectored_decode.sectored_decode_step(
            params, cfg, tstate, torch.from_numpy(tok), K_PAGES, probe=True,
            kernel="dispatch")
        fl, _ = sectored_decode.sectored_decode_step(
            params, cfg, before, torch.from_numpy(tok), K_PAGES, probe=True,
            kernel="fused")
        assert torch.equal(fl, tl)
        worst = max(worst, float(np.abs(f32(tl) - f32(jl)).max()))
        assert_greedy_agrees(tl, jl)
    assert worst <= LOGIT_TOL, worst
    np.testing.assert_array_equal(tstate.kv.length.numpy(),
                                  np.asarray(jstate.kv.length))


def test_sectored_moe_greedy_streams_match_reference(sectored_prefilled):
    """Greedy decode from the prefilled states, each side fed its own
    argmax: the streams are equal, or part only at a near tie of the
    reference's logits (see :func:`assert_greedy_agrees`), after which
    that row's inputs differ and it is compared no further."""
    jcfg, cfg, jparams, params, jstate, tstate, toks = sectored_prefilled
    tstate = tstate.clone()
    jnarrow = jax.jit(lambda s, t: jsd.sectored_decode_step(
        jparams, jcfg, s, t, K_PAGES, probe=True, kernel="dispatch"))
    jtok = ttok = toks[:, :1]
    live = np.ones(2, bool)
    compared = 0
    for _ in range(8):
        jl, jstate = jnarrow(jstate, jnp.asarray(jtok))
        tl, tstate = sectored_decode.sectored_decode_step(
            params, cfg, tstate, torch.from_numpy(np.asarray(ttok)), K_PAGES,
            probe=True, kernel="fused")
        assert_greedy_agrees(tl[live], jl[np.flatnonzero(live)])
        jtok = np.asarray(f32(jl).argmax(-1), np.int32)[:, None]
        ttok = np.asarray(f32(tl).argmax(-1), np.int32)[:, None]
        compared += int(live.sum())
        live &= (jtok == ttok)[:, 0]
    assert compared >= 12, compared
