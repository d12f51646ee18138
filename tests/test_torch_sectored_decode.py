"""Sectored decode of the port vs the JAX reference, and the reference's
own contracts held inside the port.

* Against JAX (``kernel="dispatch"``, the reference's bitwise target —
  its fused step is not bitwise with dispatch at every page edge):
  teacher-forced narrow steps with the probe page, from a state both
  sides prefilled over a three-page prompt. Page selections must be
  equal at every step and layer; logits and tables within tolerance.
* Inside the port: exact mode equals the dense ``decode_step`` bitwise,
  the fused flavor (the kernel's plain version on the CPU) equals
  dispatch bitwise, and ``fused_q8`` stays within ``LOGPROB_TOL``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import f32, small_models
from _torch_port import one_torch_thread  # noqa: F401  (autouse)
from repro.runtime import sector_predictor as jsp
from repro.runtime import sectored_decode as jsd
from repro_torch.kernels import quantized_kv
from repro_torch.models import model
from repro_torch.runtime import sector_predictor, sectored_decode

PAGE = sectored_decode.PAGE_SIZE
SEQ_LEN = 384  # 8 padded pages
PROMPT = 260  # 3 valid pages; k=1 + probe selects 2 of them
K_PAGES = 1
# bf16 logits after 260 prefill + 6 narrow steps; measured max-abs-err
# 0.0051 (a bf16 ulp at |logit| in [1, 2) is 0.0078)
LOGIT_TOL = 0.02
# f32 EMA tables (entries <= 1); measured max-abs-err 2.8e-4, from
# attention masses computed on slightly different hidden states
TABLE_TOL = 2e-3
# bf16 K/V rows past layer 0 carry the same rounding; measured 0.031
KV_TOL = 0.0625


@pytest.fixture(scope="module")
def prefilled():
    jcfg, cfg, jparams, params = small_models()
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (2, PROMPT + 8)).astype(np.int32)
    jstate = jsd.init_state(jcfg, 2, SEQ_LEN)
    tstate = sectored_decode.init_state(cfg, 2, SEQ_LEN, device="cpu")
    P = tstate.table.shape[-1]
    jexact = jax.jit(lambda s, t: jsd.sectored_decode_step(
        jparams, jcfg, s, t, P))
    for i in range(PROMPT):
        _, jstate = jexact(jstate, jnp.asarray(toks[:, i:i + 1]))
        _, tstate = sectored_decode.sectored_decode_step(
            params, cfg, tstate, torch.from_numpy(toks[:, i:i + 1]), P)
    return jcfg, cfg, jparams, params, jstate, tstate, toks


def _selections(table, length, k, pred, probe_fn, to):
    """Per-layer page selections a narrow step with probe makes."""
    return np.stack([np.asarray(pred(
        to(table[i]), to(length[i]), PAGE, k + 1,
        probe_page=probe_fn(to(length[i]), PAGE)))
        for i in range(table.shape[0])])


def test_narrow_steps_match_reference(prefilled):
    jcfg, cfg, jparams, params, jstate, tstate, toks = prefilled
    tstate = tstate.clone()
    jnarrow = jax.jit(lambda s, t: jsd.sectored_decode_step(
        jparams, jcfg, s, t, K_PAGES, probe=True, kernel="dispatch"))
    worst = 0.0
    for i in range(PROMPT, PROMPT + 6):
        want_sel = _selections(np.asarray(jstate.table),
                               np.asarray(jstate.kv.length), K_PAGES,
                               jsp.predict_topk, jsp.probe_page_for,
                               jnp.asarray)
        got_sel = _selections(tstate.table.numpy(),
                              tstate.kv.length.numpy(), K_PAGES,
                              sector_predictor.predict_topk,
                              sector_predictor.probe_page_for,
                              torch.from_numpy)
        np.testing.assert_array_equal(got_sel, want_sel)
        assert got_sel.shape[-1] < PROMPT // PAGE + 1  # really narrower
        jl, jstate = jnarrow(jstate, jnp.asarray(toks[:, i:i + 1]))
        tl, tstate = sectored_decode.sectored_decode_step(
            params, cfg, tstate, torch.from_numpy(toks[:, i:i + 1]),
            K_PAGES, probe=True, kernel="dispatch")
        worst = max(worst, float(np.abs(f32(tl) - f32(jl)).max()))
        np.testing.assert_allclose(tstate.table.numpy(),
                                   np.asarray(jstate.table), atol=TABLE_TOL)
    assert worst <= LOGIT_TOL, worst
    np.testing.assert_array_equal(tstate.kv.length.numpy(),
                                  np.asarray(jstate.kv.length))
    # layer 0: V is bitwise; K passes RoPE, whose cos/sin differ from
    # XLA's by an f32 ulp, which moves a rare element across a bf16
    # rounding boundary (measured: none of 131072 here, 4 of 131072 by
    # one bf16 ulp after a 300-token prompt)
    np.testing.assert_array_equal(f32(tstate.kv.v[0]), f32(jstate.kv.v[0]))
    k0, jk0 = f32(tstate.kv.k[0]), f32(jstate.kv.k[0])
    assert (k0 == jk0).mean() > 0.999
    np.testing.assert_allclose(k0, jk0, rtol=2 ** -7, atol=0)
    np.testing.assert_allclose(f32(tstate.kv.k), f32(jstate.kv.k),
                               atol=KV_TOL)
    np.testing.assert_allclose(f32(tstate.kv.v), f32(jstate.kv.v),
                               atol=KV_TOL)


def test_exact_mode_is_dense_bitwise(prefilled):
    """Every valid page selected, in ascending order: the gathered pages
    are the dense cache prefix, and the logits are bitwise dense."""
    _, cfg, _, params, _, _, toks = prefilled
    dense = model.init_decode_state(cfg, 2, SEQ_LEN, device="cpu")
    state = sectored_decode.init_state(cfg, 2, SEQ_LEN, device="cpu")
    assert dense.kv.k.shape == state.kv.k.shape
    P = state.table.shape[-1]
    for i in range(140):
        tok = torch.from_numpy(toks[:, i:i + 1])
        ld, dense = model.decode_step(params, cfg, dense, tok)
        ls, state = sectored_decode.sectored_decode_step(params, cfg, state,
                                                         tok, P)
        assert torch.equal(ld, ls), i
    assert torch.equal(dense.kv.k, state.kv.k)


@pytest.mark.parametrize("share_heads", [False, True])
def test_fused_plain_is_dispatch_bitwise(prefilled, share_heads):
    _, cfg, _, params, _, tstate, toks = prefilled
    cfg = dataclasses.replace(cfg, sector_share_heads=share_heads)
    a, b = tstate.clone(), tstate.clone()
    tok = torch.from_numpy(toks[:, PROMPT:PROMPT + 1])
    for _ in range(3):
        la, a = sectored_decode.sectored_decode_step(
            params, cfg, a, tok, K_PAGES, probe=True, kernel="dispatch")
        lb, b = sectored_decode.sectored_decode_step(
            params, cfg, b, tok, K_PAGES, probe=True, kernel="fused")
        assert torch.equal(la, lb)
        assert torch.equal(a.table, b.table)
        assert torch.equal(a.kv.k, b.kv.k) and torch.equal(a.kv.v, b.kv.v)
        tok = torch.argmax(la, -1, keepdim=True).to(torch.int32)


def test_fused_q8_within_logprob_tolerance(prefilled):
    """Teacher-forced fused_q8 vs dispatch: logprob max-abs-err within
    the reference's LOGPROB_TOL, and nonzero (measured 0.0096)."""
    _, cfg, _, params, _, tstate, toks = prefilled
    d, q = tstate.clone(), tstate.clone()
    worst = 0.0
    for i in range(PROMPT, PROMPT + 4):
        tok = torch.from_numpy(toks[:, i:i + 1])
        ld, d = sectored_decode.sectored_decode_step(
            params, cfg, d, tok, K_PAGES, probe=True, kernel="dispatch")
        lq, q = sectored_decode.sectored_decode_step(
            params, cfg, q, tok, K_PAGES, probe=True, kernel="fused_q8")
        err = (torch.log_softmax(ld.float(), -1)
               - torch.log_softmax(lq.float(), -1)).abs().max().item()
        worst = max(worst, err)
    assert 0 < worst <= quantized_kv.LOGPROB_TOL, worst


def test_or_merge_demands_pools_slots(prefilled):
    _, _, _, _, _, tstate, _ = prefilled
    state = tstate.clone()
    merged = sectored_decode.or_merge_demands(state, np.array([0, 0]))
    want = torch.maximum(state.table[:, 0], state.table[:, 1])
    assert torch.equal(merged.table[:, 0], want)
    assert torch.equal(merged.table[:, 1], want)
    with pytest.raises(ValueError, match="group_ids"):
        sectored_decode.or_merge_demands(state, np.array([0, 2]))


def test_backend_budgets_match_reference(prefilled):
    jcfg, cfg, jparams, params, _, _, _ = prefilled
    for seq_len in (256, 384, 2048):
        for min_topk in (1, 4):
            jb = jsd.make_serving_fns(jcfg, params=jparams, seq_len=seq_len,
                                      min_topk=min_topk)
            tb = sectored_decode.make_serving_fns(
                cfg, params=params, seq_len=seq_len, min_topk=min_topk,
                device="cpu")
            assert tb.pages == jb.pages
            for frac in (None, 0.05, 0.5, 1.0):
                assert tb.k_for(frac) == jb.k_for(frac)
                k = tb.k_for(frac)
                assert tb.probe_pages_for(k) == jb.probe_pages_for(k)
    with pytest.raises(ValueError, match="kernel"):
        sectored_decode.make_serving_fns(cfg, params=params, seq_len=256,
                                         kernel="mosaic", device="cpu")



@pytest.mark.parametrize("n_layers", [2, 32])
def test_fused_q8_at_depth_matches_reference(n_layers, capsys):
    """The int8 path at yi-6b's full depth (32 layers, reduced width) and
    at 2: teacher-forced from one synthetic cache (N(0, 1) K/V over a
    three-page prompt) bridged to both stacks, the port's fused_q8
    logprobs sit as close to the reference's fused_q8 (interpret mode) as
    the two dispatch paths sit to each other. The int8 gap itself (fused_q8
    vs dispatch) grows with depth in both stacks alike; the measured
    numbers print with ``pytest -s``."""
    from repro import configs as jconfigs
    from repro.models import model as jmodel
    from repro_torch import bridge, configs

    deep = dict(n_layers=n_layers, d_model=64, n_heads=4, n_kv_heads=2,
                d_ff=128, vocab=128, head_dim=32)
    jcfg = jconfigs.get("yi-6b").reduced(**deep)
    cfg = configs.get("yi-6b").reduced(**deep)
    jparams = jax.jit(lambda key: jmodel.init_params(jcfg, key))(
        jax.random.key(0))
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      device="cpu")
    rng = np.random.default_rng(0)
    jstate = jsd.init_state(jcfg, 2, SEQ_LEN)
    kv_shape = jstate.kv.k.shape  # (L, B, Spad, Hkv, hd)
    live = (np.arange(kv_shape[2]) < PROMPT)[None, None, :, None, None]
    k, v = (jnp.asarray(rng.normal(size=kv_shape) * live, jnp.bfloat16)
            for _ in range(2))
    P = jstate.table.shape[-1]
    n_valid = (PROMPT - 1) // PAGE + 1
    table = rng.random(jstate.table.shape) * (np.arange(P) < n_valid)
    jstate = dataclasses.replace(
        jstate, kv=dataclasses.replace(
            jstate.kv, k=k, v=v,
            length=jnp.full(jstate.kv.length.shape, PROMPT, jnp.int32)),
        table=jnp.asarray(table, jnp.float32),
        position=jnp.full((2,), PROMPT, jnp.int32))

    def to_port(s):
        t = [bridge.tensor_from_numpy(np.asarray(x), device="cpu")
             for x in (s.kv.k, s.kv.v, s.kv.length, s.table, s.position)]
        return sectored_decode.SectoredState(
            kv=sectored_decode.attention.KVCache(k=t[0], v=t[1],
                                                 length=t[2]),
            table=t[3], position=t[4])

    jsteps = {kernel: jax.jit(lambda s, t, kernel=kernel:
                              jsd.sectored_decode_step(
                                  jparams, jcfg, s, t, K_PAGES, probe=True,
                                  kernel=kernel))
              for kernel in ("dispatch", "fused_q8")}
    jd = jq = jstate
    td, tq = to_port(jstate), to_port(jstate)
    toks = rng.integers(0, cfg.vocab, (2, 4)).astype(np.int32)
    worst = dict(ref_gap=0.0, port_gap=0.0, q8_port_vs_ref=0.0,
                 dispatch_port_vs_ref=0.0)
    for i in range(toks.shape[1]):
        tok = toks[:, i:i + 1]
        jld, jd = jsteps["dispatch"](jd, jnp.asarray(tok))
        jlq, jq = jsteps["fused_q8"](jq, jnp.asarray(tok))
        ld, td = sectored_decode.sectored_decode_step(
            params, cfg, td, torch.from_numpy(tok), K_PAGES, probe=True,
            kernel="dispatch")
        lq, tq = sectored_decode.sectored_decode_step(
            params, cfg, tq, torch.from_numpy(tok), K_PAGES, probe=True,
            kernel="fused_q8")
        jlp = {n: np.asarray(jax.nn.log_softmax(f32(x)))
               for n, x in (("d", jld), ("q", jlq))}
        tlp = {n: torch.log_softmax(x.float(), -1).numpy()
               for n, x in (("d", ld), ("q", lq))}
        for name, err in (
                ("ref_gap", jlp["q"] - jlp["d"]),
                ("port_gap", tlp["q"] - tlp["d"]),
                ("q8_port_vs_ref", tlp["q"] - jlp["q"]),
                ("dispatch_port_vs_ref", tlp["d"] - jlp["d"])):
            worst[name] = max(worst[name], float(np.abs(err).max()))
    with capsys.disabled():
        print(f"\nfused_q8, {n_layers} layers, max logprob abs err over 4 "
              f"steps: {worst}")
    assert worst["ref_gap"] > 0 and worst["port_gap"] > 0
    # int8 adds nothing of the port's own: its int8 path is as close to
    # the reference's as its plain path is (bf16 sums in another order)
    assert worst["q8_port_vs_ref"] <= 2 * worst["dispatch_port_vs_ref"]
