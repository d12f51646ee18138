"""Paged sectored attention of the port vs the JAX reference's Pallas
kernel (run as the reference's own tests run it here: interpret mode).

On CPU tensors the port's wrapper takes its plain version, so these
tests hold that plain version — which the CUDA kernel is held to on the
card, by ``chip_smoke.py`` and ``tests/test_torch_cuda.py`` — to the
reference, in both flavors and at the shapes the reference's fused
kernel tests sweep: shared page sets, K == P, ragged lengths and the
``k*page +- 1`` mask edges.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread  # noqa: F401  (autouse)
from repro.kernels import ops as jops
from repro.kernels import quantized_kv as jqkv
from repro_torch import bridge, configs
from repro_torch.kernels import backend, quantized_kv, sectored_attention
from repro_torch.models import model
from repro_torch.runtime import sectored_decode

# f32 outputs of size ~1 after f32-accumulated sums in another order
# (XLA's dot vs torch's); measured max-abs-err over CASES: bf16 3.0e-7
# (out) and 1.5e-7 (mass), int8 3.6e-7 (out) and 3.0e-7 (mass)
OUT_TOL = 1e-5


def make_case(seed, B, Hkv, rep, P, page, hd, K, *, shared=False,
              lengths=None):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Hkv, rep, hd)).astype(np.float32)
    kp = rng.normal(size=(B, P, page, Hkv, hd)).astype(np.float32)
    vp = rng.normal(size=(B, P, page, Hkv, hd)).astype(np.float32)
    heads = 1 if shared else Hkv
    idx = np.stack([np.sort(rng.choice(P, K, replace=False))
                    for _ in range(B * heads)]).reshape(B, heads, K)
    if lengths is None:
        lengths = rng.integers(1, P * page + 1, B)
    return (q, kp, vp, idx.astype(np.int32),
            np.asarray(lengths, np.int32))


def run_both(case, quantized):
    q, kp, vp, idx, length = case
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, kp, vp))
    tq, tk, tv = (bridge.tensor_from_numpy(np.asarray(a), device="cpu")
                  for a in (jq, jk, jv))
    tidx, tlen = torch.from_numpy(idx), torch.from_numpy(length)
    if quantized:
        jk, ks = jqkv.quantize_pages(jk)
        jv, vs = jqkv.quantize_pages(jv)
        tk, tks = quantized_kv.quantize_pages(tk)
        tv, tvs = quantized_kv.quantize_pages(tv)
        want = jops.sectored_attention_paged(
            jq, jk, jv, jnp.asarray(idx), jnp.asarray(length),
            k_scale=ks, v_scale=vs, interpret=True)
        got = sectored_attention.sectored_attention_paged(
            tq, tk, tv, tidx, tlen, k_scale=tks, v_scale=tvs)
    else:
        want = jops.sectored_attention_paged(
            jq, jk, jv, jnp.asarray(idx), jnp.asarray(length),
            interpret=True)
        got = sectored_attention.sectored_attention_paged(
            tq, tk, tv, tidx, tlen)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


CASES = {
    "random": dict(seed=0, B=2, Hkv=2, rep=2, P=6, page=16, hd=32, K=3),
    "shared": dict(seed=1, B=2, Hkv=2, rep=2, P=6, page=16, hd=32, K=3,
                   shared=True),
    "k_eq_p": dict(seed=2, B=2, Hkv=2, rep=4, P=4, page=16, hd=32, K=4),
    "ragged": dict(seed=3, B=3, Hkv=1, rep=3, P=5, page=16, hd=32, K=2,
                   lengths=[1, 17, 80]),
    "edge_minus": dict(seed=4, B=2, Hkv=2, rep=2, P=4, page=128, hd=32, K=4,
                       lengths=[2 * 128 - 1, 3 * 128 - 1]),
    "edge_at": dict(seed=5, B=2, Hkv=2, rep=2, P=4, page=128, hd=32, K=4,
                    lengths=[2 * 128, 3 * 128]),
    "edge_plus": dict(seed=6, B=2, Hkv=2, rep=2, P=4, page=128, hd=32, K=4,
                      lengths=[2 * 128 + 1, 3 * 128 + 1]),
}


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_reference_kernel(name, quantized):
    sectored_attention.reset_launches()
    (want_out, want_mass), (got_out, got_mass) = run_both(
        make_case(**CASES[name]), quantized)
    np.testing.assert_allclose(got_out, want_out, rtol=0, atol=OUT_TOL)
    np.testing.assert_allclose(got_mass, want_mass, rtol=0, atol=OUT_TOL)
    # CPU tensors take the plain version: no kernel was launched
    assert sectored_attention.launches == {"bf16": 0, "int8": 0}


def test_quantize_pages_matches_reference():
    rng = np.random.default_rng(7)
    pages = jnp.asarray(rng.normal(size=(2, 3, 16, 2, 32)) * 3, jnp.bfloat16)
    jq, js = jqkv.quantize_pages(pages)
    tq, ts = quantized_kv.quantize_pages(
        bridge.tensor_from_numpy(np.asarray(pages), device="cpu"))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        quantized_kv.dequantize_pages(tq, ts).numpy(),
        np.asarray(jqkv.dequantize_pages(jq, js)))
    assert quantized_kv.kv_word_fraction() == jqkv.kv_word_fraction() == 0.5
    assert quantized_kv.LOGPROB_TOL == jqkv.LOGPROB_TOL


def _tensors(case):
    q, kp, vp, idx, length = case
    return (torch.from_numpy(q).bfloat16(), torch.from_numpy(kp).bfloat16(),
            torch.from_numpy(vp).bfloat16(), torch.from_numpy(idx),
            torch.from_numpy(length))


@pytest.mark.parametrize("bad", ["ndim", "heads", "one_scale", "shape"])
def test_bad_shapes_raise(bad):
    q, kp, vp, idx, length = _tensors(make_case(**CASES["random"]))
    kwargs = {}
    if bad == "ndim":
        idx = idx[:, 0]
    elif bad == "heads":
        idx = torch.cat([idx, idx[:, :1]], dim=1)  # 3 heads vs Hkv=2
    elif bad == "one_scale":
        kwargs = dict(k_scale=torch.ones(2, 6, 2))
    else:
        vp = vp[:, :, :8]
    with pytest.raises(ValueError):
        sectored_attention.sectored_attention_paged(q, kp, vp, idx, length,
                                                    **kwargs)


def test_no_fallback_off_the_cpu():
    """Tensors that are neither all on the CPU nor all on one CUDA device
    raise; they never drop to the plain version."""
    q, kp, vp, idx, length = _tensors(make_case(**CASES["random"]))
    with pytest.raises(ValueError, match="one CUDA device or all on the CPU"):
        sectored_attention.sectored_attention_paged(
            q.to("meta"), kp, vp, idx, length)


def test_device_none_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get("yi-6b").reduced(n_layers=1, d_model=64, n_heads=4,
                                       n_kv_heads=2, d_ff=128, vocab=128,
                                       head_dim=32)
    with pytest.raises(RuntimeError, match="cuda"):
        backend.resolve_device(None)
    with pytest.raises(RuntimeError, match="cuda"):
        model.init_params(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        sectored_decode.init_state(cfg, 1, 64)
    params = model.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        sectored_decode.make_serving_fns(cfg, params=params, seq_len=64)


def test_kernel_source_is_packaged():
    """The CUDA source the wrapper builds ships inside the package."""
    from repro_torch.kernels import build
    assert sectored_attention.SOURCE in build.sources()
    text = (build.CSRC / f"{sectored_attention.SOURCE}.cu").read_text()
    assert "_paged_kernel" in text and "__expf" not in text
    assert "--use_fast_math" not in build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
