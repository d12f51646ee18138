"""The port's kernel entry point ``repro_torch.kernels.ops`` vs the JAX
package's ``repro.kernels.ops``: head-major sectored attention, VBL gather
and flash attention.

On CPU tensors each wrapper takes its plain version, so these tests hold
the plain versions — which the CUDA kernels are held to on the card, by
``chip_smoke.py`` and ``tests/test_torch_cuda.py`` — to the reference's
Pallas kernels, run as the reference's own tests run them here (interpret
mode), on a few small cases, and to the reference's jitted oracles
(``repro.kernels.ref``) on the wider sweeps. Inputs are made with numpy
from a seed and carried to both packages bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread  # noqa: F401  (autouse)
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import bridge
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops
from repro_torch.kernels import sectored_attention as tsa
from repro_torch.kernels import vbl_gather as tvbl

PAGE = 128
SA_REF_JIT = jax.jit(jref.sectored_attention_ref)
VBL_REF_JIT = jax.jit(jref.vbl_gather_ref)
FLASH_REF_JIT = jax.jit(jref.flash_attention_ref, static_argnames="causal")

# Head-major sectored attention: both sides compute in f32 for either
# input dtype, with sums in another order (XLA's dot vs torch's); outputs
# are of size ~1. Measured max-abs-err over every case here: 2.4e-7 (2 of
# the 16 jitted-oracle cases bitwise, so no case asserts bitwise).
SA_TOL = 2e-5
# Flash attention: the reference's own tolerances (tests/test_kernels.py),
# rtol = atol. bf16: both sides round an f32 result to bf16, one ulp apart
# at most (2**-8 relative). Measured max-abs-err: f32 6.0e-7, bf16 2.0e-3
# (one bf16 ulp at |out| < 0.5).
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
          "int32": jnp.int32}


@pytest.fixture(autouse=True)
def no_launches_on_the_cpu():
    """CPU tensors take the plain versions: no kernel launches."""
    ops.reset_launches()
    yield
    assert not any(ops.launch_counts().values()), ops.launch_counts()


def to_torch(a) -> torch.Tensor:
    return bridge.tensor_from_numpy(np.asarray(a), device="cpu")


def bits(x) -> np.ndarray:
    """Raw bits of a torch tensor or JAX array (bf16 as uint16)."""
    if isinstance(x, torch.Tensor):
        return bridge.tensor_to_numpy_bits(x)
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


# -- VBL gather ---------------------------------------------------------------


def vbl_case(seed, N, W, dtype):
    """Data with some -0.0 entries, and masks that include the full, the
    empty and a high-bits-only (0xFFFFFF00: count 0) mask."""
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        data = jnp.asarray(rng.integers(-100, 100, (N, 8, W)), jnp.int32)
    else:
        vals = rng.normal(size=(N, 8, W))
        vals[:, :, 0] = -0.0
        data = jnp.asarray(vals, JDTYPE[dtype])
    masks = rng.integers(0, 2 ** 32, N, dtype=np.uint64).astype(np.uint32)
    masks[:3] = [0xFF, 0x00, 0xFFFFFF00][:N]
    return data, masks


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_vbl_bitwise_vs_reference_kernel(dtype):
    data, masks = vbl_case(0, 16, 128, dtype)
    want, wcnt = jops.vbl_gather(data, jnp.asarray(masks), interpret=True)
    got, cnt = ops.vbl_gather(to_torch(data), torch.from_numpy(masks))
    assert got.dtype == to_torch(data).dtype and cnt.dtype == torch.int32
    np.testing.assert_array_equal(bits(got), bits(want))  # -0.0 kept too
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(wcnt))
    assert cnt[:3].tolist() == [8, 0, 0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("N,W", [(3, 128), (16, 128), (5, 3), (4, 256)])
@pytest.mark.parametrize("mask_dtype", ["uint32", "int32", "int64"])
def test_vbl_matches_jitted_ref(N, W, dtype, mask_dtype):
    """By value, as the reference's own tests compare (its jnp oracle adds
    into zeros, so it returns +0.0 where the kernels copy a -0.0); masks
    given as uint32 or as int32 / int64 holding the same low 32 bits."""
    data, masks = vbl_case(N * W, N, W, dtype)
    want, wcnt = VBL_REF_JIT(data, jnp.asarray(masks))
    tmasks = torch.from_numpy(masks)
    if mask_dtype == "int32":
        tmasks = torch.from_numpy(masks.view(np.int32))
    elif mask_dtype == "int64":
        tmasks = torch.from_numpy(masks.astype(np.int64))
    got, cnt = ops.vbl_gather(to_torch(data), tmasks)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(wcnt))


def test_vbl_full_and_empty_masks():
    data = torch.arange(2 * 8 * 128, dtype=torch.float32).reshape(2, 8, 128)
    out, cnt = ops.vbl_gather(data, torch.tensor([0xFF, 0x00],
                                                 dtype=torch.int64))
    assert torch.equal(out[0], data[0]) and not out[1].any()
    assert cnt.tolist() == [8, 0]


# -- head-major sectored attention ----------------------------------------------


def sa_case(seed, B, Hkv, rep, P, page, hd, K, dtype, *, shared=False,
            lengths=None):
    rng = np.random.default_rng(seed)
    q, kp, vp = (jnp.asarray(rng.normal(size=s), JDTYPE[dtype])
                 for s in ((B, Hkv, rep, hd), (B, Hkv, P, page, hd),
                           (B, Hkv, P, page, hd)))
    heads = 1 if shared else Hkv
    idx = np.stack([np.sort(rng.choice(P, K, replace=False))
                    for _ in range(B * heads)]).reshape(B, heads, K)
    if lengths is None:
        lengths = rng.integers(1, P * page + 1, B)
    return q, kp, vp, idx.astype(np.int32), np.asarray(lengths, np.int32)


def run_port_sa(case):
    q, kp, vp, idx, length = case
    return ops.sectored_attention(to_torch(q), to_torch(kp), to_torch(vp),
                                  torch.from_numpy(idx),
                                  torch.from_numpy(length)).numpy()


def jax_args(case):
    q, kp, vp, idx, length = case
    return q, kp, vp, jnp.asarray(idx), jnp.asarray(length)


# the shapes of tests/test_kernels_fused.py's bitwise sweep
SA_SHAPES = {
    "1x1x2_P4_hd32_K2": (1, 1, 2, 4, 32, 2),
    "2x2x4_P8_hd64_K4": (2, 2, 4, 8, 64, 4),
    "K_eq_P": (1, 2, 2, 4, 32, 4),
    "2x1x8_P8_hd32_K3": (2, 1, 8, 8, 32, 3),
}


@pytest.mark.parametrize("name,dtype", [("K_eq_P", "float32"),
                                        ("2x2x4_P8_hd64_K4", "bfloat16")])
def test_sectored_attention_vs_reference_kernel(name, dtype):
    B, Hkv, rep, P, hd, K = SA_SHAPES[name]
    case = sa_case(1, B, Hkv, rep, P, PAGE, hd, K, dtype)
    want = jops.sectored_attention(*jax_args(case), interpret=True)
    np.testing.assert_allclose(run_port_sa(case), np.asarray(want),
                               rtol=0, atol=SA_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(SA_SHAPES))
@pytest.mark.parametrize("seed", [0, 1])
def test_sectored_attention_vs_jitted_ref(name, dtype, seed):
    """Ragged random lengths, K < P and K == P, against the reference
    kernel's bitwise target (the jitted oracle)."""
    B, Hkv, rep, P, hd, K = SA_SHAPES[name]
    case = sa_case(seed, B, Hkv, rep, P, PAGE, hd, K, dtype)
    np.testing.assert_allclose(run_port_sa(case),
                               np.asarray(SA_REF_JIT(*jax_args(case))),
                               rtol=0, atol=SA_TOL)


@pytest.mark.parametrize("page", [128, 256])
@pytest.mark.parametrize("lengths", [[2 * 128 - 1, 1], [2 * 128, 0],
                                     [2 * 128 + 1, 4 * 128]])
def test_sectored_attention_mask_edges(page, lengths):
    """``length`` is a count at the k*page - 1 / k*page / k*page + 1 edges;
    a length of 0 gives 0, not NaN; a repeated page counts twice."""
    case = sa_case(3, 2, 2, 2, 4, page, 32, 4, "float32", lengths=lengths)
    q, kp, vp, idx, length = case
    idx = idx.copy()
    idx[0, 0, 1] = idx[0, 0, 0]  # duplicate page index
    case = (q, kp, vp, idx, length)
    got = run_port_sa(case)
    np.testing.assert_allclose(got, np.asarray(SA_REF_JIT(*jax_args(case))),
                               rtol=0, atol=SA_TOL)
    assert np.isfinite(got).all()
    if 0 in lengths:
        assert not got[lengths.index(0)].any()


def test_sectored_attention_shared_page_set():
    """(B, 1, K) page_idx: one page set per sequence, equal to the reference
    kernel and to the explicit per-head broadcast inside the port."""
    case = sa_case(11, 2, 4, 2, 8, PAGE, 32, 4, "float32", shared=True)
    want = jops.sectored_attention(*jax_args(case), interpret=True)
    got = run_port_sa(case)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=SA_TOL)
    q, kp, vp, idx, length = case
    bcast = np.ascontiguousarray(np.broadcast_to(idx, (2, 4, 4)))
    np.testing.assert_array_equal(run_port_sa((q, kp, vp, bcast, length)),
                                  got)


def test_sectored_attention_masks_future_pages():
    """Pages wholly beyond ``length`` contribute nothing (the reference's
    test_kernels.py case, against its kernel)."""
    q, kp, vp, _, _ = sa_case(3, 1, 1, 2, 4, PAGE, 64, 2, "float32")
    length = np.array([PAGE - 1], np.int32)  # only page 0 valid
    outs = []
    for pages in ([0, 3], [0, 2]):
        case = (q, kp, vp, np.array([[pages]], np.int32), length)
        want = jops.sectored_attention(*jax_args(case), interpret=True)
        outs.append(run_port_sa(case))
        np.testing.assert_allclose(outs[-1], np.asarray(want), rtol=0,
                                   atol=SA_TOL)
    np.testing.assert_array_equal(outs[0], outs[1])


# -- flash attention --------------------------------------------------------------


def flash_case(seed, shape, dtype):
    rng = np.random.default_rng(seed)
    return [jnp.asarray(rng.normal(size=shape), JDTYPE[dtype])
            for _ in range(3)]


def run_port_flash(qkv, **kw):
    out = ops.flash_attention(*(to_torch(a) for a in qkv), **kw)
    assert out.dtype == to_torch(qkv[0]).dtype
    return out.float().numpy()


@pytest.mark.parametrize("shape,dtype,causal", [
    ((1, 1, 128, 64), "float32", True),
    ((2, 1, 256, 32), "bfloat16", True),
    ((1, 1, 128, 64), "bfloat16", False),
    ((2, 1, 256, 32), "float32", False),
])
def test_flash_vs_reference_kernel(shape, dtype, causal):
    qkv = flash_case(0, shape, dtype)
    want = jops.flash_attention(*qkv, causal=causal, interpret=True)
    tol = FLASH_TOL[dtype]
    np.testing.assert_allclose(run_port_flash(qkv, causal=causal),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 1, 128, 64), (2, 1, 256, 32),
                                   (1, 2, 64, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_vs_jitted_ref(shape, dtype, causal):
    qkv = flash_case(1, shape, dtype)
    want = FLASH_REF_JIT(*qkv, causal=causal).astype(JDTYPE[dtype])
    tol = FLASH_TOL[dtype]
    np.testing.assert_allclose(run_port_flash(qkv, causal=causal),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("block_q,block_k", [(64, 128), (128, 64), (64, 64)])
def test_flash_block_shapes(block_q, block_k):
    qkv = flash_case(2, (1, 2, 256, 64), "float32")
    want = jops.flash_attention(*qkv, block_q=block_q, block_k=block_k,
                                interpret=True)
    np.testing.assert_allclose(
        run_port_flash(qkv, block_q=block_q, block_k=block_k),
        np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("block_q,block_k", [(96, 128), (128, 96)])
def test_flash_ragged_block_raises_in_both(block_q, block_k):
    qkv = flash_case(3, (1, 1, 256, 32), "float32")
    with pytest.raises(AssertionError):
        jops.flash_attention(*qkv, block_q=block_q, block_k=block_k,
                             interpret=True)
    with pytest.raises(ValueError, match="multiple"):
        ops.flash_attention(*(to_torch(a) for a in qkv), block_q=block_q,
                            block_k=block_k)


# -- the wrappers' contract ---------------------------------------------------------


def small_inputs():
    """One small valid input set per wrapper, as CPU tensors."""
    sa = sa_case(5, 1, 2, 2, 4, 16, 32, 2, "float32")
    data, masks = vbl_case(5, 3, 8, "float32")
    return {
        "sectored_attention": [to_torch(sa[0]), to_torch(sa[1]),
                               to_torch(sa[2]), torch.from_numpy(sa[3]),
                               torch.from_numpy(sa[4])],
        "vbl_gather": [to_torch(data), torch.from_numpy(masks)],
        "flash_attention": [to_torch(a)
                            for a in flash_case(5, (1, 1, 64, 32),
                                                "float32")],
    }


@pytest.mark.parametrize("name", ["sectored_attention", "vbl_gather",
                                  "flash_attention"])
def test_mixed_devices_raise(name):
    args = small_inputs()[name]
    args[0] = args[0].to("meta")
    with pytest.raises(ValueError, match="one CUDA device or all on the CPU"):
        getattr(ops, name)(*args)


@pytest.mark.parametrize("name,arg", [
    ("sectored_attention", 0), ("sectored_attention", 1),
    ("sectored_attention", 3), ("vbl_gather", 0), ("vbl_gather", 1),
    ("flash_attention", 0), ("flash_attention", 2)])
def test_dtypes_not_taken_raise(name, arg):
    args = small_inputs()[name]
    bad = {torch.float32: torch.float16, torch.int32: torch.int16,
           torch.uint32: torch.float32}[args[arg].dtype]
    args[arg] = args[arg].to(bad)
    with pytest.raises(TypeError):
        getattr(ops, name)(*args)


def test_shapes_not_taken_raise():
    sa = small_inputs()["sectored_attention"]
    with pytest.raises(ValueError, match="head_dim"):
        ops.sectored_attention(sa[0][..., :16], sa[1][..., :16],
                               sa[2][..., :16], *sa[3:])
    with pytest.raises(ValueError, match="head axis"):
        ops.sectored_attention(*sa[:3], torch.cat([sa[3], sa[3][:, :1]], 1),
                               sa[4])
    data, masks = small_inputs()["vbl_gather"]
    with pytest.raises(ValueError):
        ops.vbl_gather(data[:, :7], masks)
    with pytest.raises(ValueError):
        ops.vbl_gather(data, masks[:2])
    q, k, v = small_inputs()["flash_attention"]
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention(q[..., :16], k[..., :16], v[..., :16])
    with pytest.raises(ValueError):
        ops.flash_attention(q, k[:, :, :32], v)


def test_ops_exposes_every_kernel():
    assert set(ops.__all__) >= set(jops.__all__) - {"default_interpret"}
    assert ops.sectored_attention_paged is tsa.sectored_attention_paged
    assert ops.sectored_attention is tsa.sectored_attention
    assert ops.vbl_gather is tvbl.vbl_gather
    assert ops.flash_attention is tflash.flash_attention
    assert set(ops.launch_counts()) == {
        "sectored_attention_paged_bf16", "sectored_attention_paged_int8",
        "sectored_attention_f32", "sectored_attention_bf16", "vbl_gather",
        "flash_attention_f32", "flash_attention_bf16"}


@pytest.mark.parametrize("module,tpu_kernel", [
    (tsa, "_ref_kernel"), (tvbl, "_kernel"), (tflash, "_kernel")])
def test_kernel_sources_are_packaged(module, tpu_kernel):
    """Each wrapper's CUDA source ships in the package, names the TPU
    kernel it replaces, and builds without fast math."""
    from repro_torch.kernels import build
    name = getattr(module, "HEAD_MAJOR_SOURCE", None) or module.SOURCE
    assert name in build.sources()
    text = (build.CSRC / f"{name}.cu").read_text()
    assert f"`{tpu_kernel}`" in text and "__expf" not in text
    assert "--use_fast_math" not in build.NVCC_FLAGS
