"""repro_torch model layers vs the JAX reference, on the CPU.

The same inputs (numpy, from a seeded generator) and the same parameters
(the reference's ``init_params``, bridged bit for bit) go through both
implementations. Where the port computes the reference's expression
with a different library's float kernels (exp, cos, sums in another
order) the results are held to a stated tolerance; integer outputs and
the first layer's K/V rows, which see no such kernel after rounding to
bf16, are held to equality.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import SMALL, bf16_pair, f32, small_models
from _torch_port import one_torch_thread  # noqa: F401  (autouse)
from repro import configs as jconfigs
from repro.models import attention as jattention
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro_torch import configs
from repro_torch.models import attention, layers, model

# bf16 logits of the reduced model: the two stacks round bf16 products
# and exp/cos at different ulps; measured max-abs-err 0.0059 over 10
# teacher-forced steps (one bf16 ulp at |logit| ~ 1 is 0.0078)
LOGIT_TOL = 0.02


@pytest.fixture(scope="module")
def small():
    return small_models()


def test_rms_norm_bitwise():
    rng = np.random.default_rng(0)
    jx, tx = bf16_pair(rng, (4, 3, 64))
    js, ts = bf16_pair(rng, (64,))
    np.testing.assert_array_equal(f32(jlayers.rms_norm(jx, js)),
                                  f32(layers.rms_norm(tx, ts)))


@pytest.mark.parametrize("kind", ["standard", "rope2d", "mrope", "none"])
def test_apply_rope(kind):
    """Split-half rotation per kind. cos/sin differ from XLA's by at most
    one f32 ulp (measured 6e-8), which the bf16 output hides except at a
    rounding boundary: bf16 ulp at |x| < 4 is at most 0.0156. Measured
    max-abs-err 0.0 for all three kinds on these inputs."""
    rng = np.random.default_rng(1)
    jx, tx = bf16_pair(rng, (3, 5, 4, 32))
    pos = rng.integers(0, 2000, (3, 5)).astype(np.int32)
    want = f32(jlayers.apply_rope(jx, jnp.asarray(pos), kind))
    got = f32(layers.apply_rope(tx, torch.from_numpy(pos), kind))
    np.testing.assert_allclose(got, want, rtol=0, atol=0.0157)
    assert (got == want).mean() > 0.99


def test_swiglu_and_unembed(small):
    jcfg, cfg, jparams, params = small
    rng = np.random.default_rng(2)
    jx, tx = bf16_pair(rng, (4, 1, 64))
    jmlp = jax.tree.map(lambda a: a[0], jparams["layers"]["mlp"])
    tmlp = {k: v[0] for k, v in params["layers"]["mlp"].items()}
    # silu's sigmoid differs at f32 ulps: bf16 outputs of size ~0.5 within
    # two bf16 ulps (measured 0.0)
    np.testing.assert_allclose(f32(layers.swiglu(tmlp, tx)),
                               f32(jlayers.swiglu(jmlp, jx)), atol=8e-3)
    np.testing.assert_array_equal(
        f32(layers.unembed(params, tx, False)),
        f32(jlayers.unembed(jparams, jx, False)))
    tok = rng.integers(0, 128, (4, 1)).astype(np.int32)
    np.testing.assert_array_equal(
        f32(layers.embed(params, torch.from_numpy(tok))),
        f32(jlayers.embed(jparams, jnp.asarray(tok))))


def test_qkv_and_decode_attend(small):
    """One decode_attend from a cache holding 37 rows: the K/V append is
    bitwise; q, k and the attention output within bf16 rounding (measured
    max-abs-err 0.0 for each)."""
    jcfg, cfg, jparams, params = small
    rng = np.random.default_rng(3)
    jattn = jax.tree.map(lambda a: a[0], jparams["layers"]["attn"])
    tattn = {k: v[0] for k, v in params["layers"]["attn"].items()}
    jx, tx = bf16_pair(rng, (2, 1, 64))
    pos = np.array([[37], [5]], np.int32)
    jq, jk, jv = jattention.qkv(jattn, jcfg, jx, jnp.asarray(pos))
    tq, tk, tv = attention.qkv(tattn, cfg, tx, torch.from_numpy(pos))
    for a, b in ((jq, tq), (jk, tk), (jv, tv)):
        np.testing.assert_allclose(f32(b), f32(a), atol=0.0157)
    np.testing.assert_array_equal(f32(tv), f32(jv))  # no rope on v

    jk0, tk0 = bf16_pair(rng, (2, 64, 2, 32))
    jv0, tv0 = bf16_pair(rng, (2, 64, 2, 32))
    length = np.array([37, 5], np.int32)
    jcache = jattention.KVCache(k=jk0, v=jv0, length=jnp.asarray(length))
    tcache = attention.KVCache(k=tk0.clone(), v=tv0.clone(),
                               length=torch.from_numpy(length))
    jout, jnew = jattention.decode_attend(jattn, jcfg, jx, jcache)
    tout, tnew = attention.decode_attend(tattn, cfg, tx, tcache)
    # measured max-abs-err 0.0 on this case; bf16 outputs ~1 in magnitude
    np.testing.assert_allclose(f32(tout), f32(jout), atol=0.0157)
    np.testing.assert_array_equal(f32(tnew.k), f32(jnew.k))
    np.testing.assert_array_equal(f32(tnew.v), f32(jnew.v))
    np.testing.assert_array_equal(tnew.length.numpy(),
                                  np.asarray(jnew.length))
    assert tcache.k is tnew.k  # the append is in place


def test_decode_step_teacher_forced(small):
    jcfg, cfg, jparams, params = small
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab, (2, 10)).astype(np.int32)
    jstate = jmodel.init_decode_state(jcfg, 2, 40)
    tstate = model.init_decode_state(cfg, 2, 40, device="cpu")
    step = jax.jit(lambda s, t: jmodel.decode_step(jparams, jcfg, s, t))
    worst = 0.0
    for i in range(toks.shape[1]):
        jl, jstate = step(jstate, jnp.asarray(toks[:, i:i + 1]))
        tl, tstate = model.decode_step(params, cfg, tstate,
                                       torch.from_numpy(toks[:, i:i + 1]))
        assert tl.dtype == torch.bfloat16 and tl.shape == (2, cfg.vocab)
        worst = max(worst, float(np.abs(f32(tl) - f32(jl)).max()))
    assert worst <= LOGIT_TOL, worst
    np.testing.assert_array_equal(tstate.position.numpy(),
                                  np.asarray(jstate.position))
    # layer 0's K/V rows depend on nothing past the embedding and RoPE
    np.testing.assert_array_equal(f32(tstate.kv.k[0]), f32(jstate.kv.k[0]))


def test_every_family_builds_and_true_sectored_refuses_recurrent():
    """All ten configs build and step; ``--true-sectored`` still refuses
    the attention-free and hybrid families with the reference's
    ``ValueError`` (they have no KV cache to page), and accepts MoE."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as launch_serve

    for name in configs.ARCHS:
        cfg = configs.get(name).reduced()
        params = model.init_params(cfg, device="cpu")
        logits, state = model.prefill(params, cfg,
                                      torch.zeros((1, 3), dtype=torch.int32))
        assert logits.shape == (1, cfg.vocab)
        assert model.decode_step_(params, cfg, state, torch.zeros(
            (1, 1), dtype=torch.int32)).shape == (1, cfg.vocab)
        if cfg.uniform_layers:
            launch_serve.build_backend(cfg, params, true_sectored=True,
                                       device="cpu")
            continue
        jcfg = jconfigs.get(name).reduced()
        with pytest.raises(ValueError) as want:
            jserve.build_backend(jcfg, None, true_sectored=True)
        with pytest.raises(ValueError) as got:
            launch_serve.build_backend(cfg, params, true_sectored=True,
                                       device="cpu")
        assert str(got.value) == str(want.value)


def test_configs_match_reference():
    for name, cfg in configs.ARCHS.items():
        ref = jconfigs.get(name)
        assert cfg.__class__.__name__ == ref.__class__.__name__
        for field in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                      "vocab", "head_dim_", "rope", "qk_norm", "qkv_bias",
                      "layer_kinds", "uniform_layers", "tie_embeddings"):
            assert getattr(cfg, field) == getattr(ref, field), (name, field)
        assert (cfg.reduced(**SMALL).head_dim_
                == ref.reduced(**SMALL).head_dim_)
