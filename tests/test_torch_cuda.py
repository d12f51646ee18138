"""repro_torch on the GPU: the CUDA kernel vs its plain version on the
same CUDA tensors, the fused decode step vs the dispatch step, the
serving path's captured CUDA graphs vs its eager steps (bitwise), and the
sampler's threefry draws on the card vs the CPU's.

Every test here needs a CUDA GPU and skips without one. This file imports
neither JAX nor the JAX package, so it runs on a machine with only
PyTorch: ``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
"""

import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import (flash_attention, ops, quantized_kv,
                                 sectored_attention, vbl_gather)
from repro_torch.launch import serve as launch_serve
from repro_torch.models import model
from repro_torch.runtime import graphs, sectored_decode
from repro_torch.sample import (SamplerRows, SamplerSpec, kernel, rng,
                                sample_from_logits)
from repro_torch.serve import AlwaysDense, Request, ServeSession
from repro_torch.serve import make_fused_wave

pytestmark = pytest.mark.cuda

# see chip_smoke.KERNEL_TOL: sums in another order can flip bf16(e) by one
# bf16 ulp on a few weights in the bf16 flavor; the int8 flavor keeps e f32
OUT_TOL = {"bf16": 2e-2, "int8": 1e-4}
MASS_TOL = 1e-5


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run on the H100: see README)")
    return torch.device("cuda")


def _case(gpu, B, Hkv, rep, hd, P, K, lengths, shared=False, seed=0):
    gen = torch.Generator(device=gpu)
    gen.manual_seed(seed)
    q = torch.randn((B, Hkv, rep, hd), generator=gen, device=gpu).bfloat16()
    kp = torch.randn((B, P, 128, Hkv, hd), generator=gen,
                     device=gpu).bfloat16()
    vp = torch.randn((B, P, 128, Hkv, hd), generator=gen,
                     device=gpu).bfloat16()
    heads = 1 if shared else Hkv
    idx = torch.stack([torch.sort(torch.randperm(P, generator=gen,
                                                 device=gpu)[:K]).values
                       for _ in range(B * heads)]).reshape(B, heads, K)
    length = torch.tensor(lengths, dtype=torch.int32, device=gpu)
    return q, kp, vp, idx.to(torch.int32), length


@pytest.mark.parametrize("flavor", ["bf16", "int8"])
@pytest.mark.parametrize("shape", [
    dict(B=4, Hkv=4, rep=8, hd=128, P=24, K=5,
         lengths=[700, 768, 129, 3000]),
    dict(B=2, Hkv=2, rep=8, hd=128, P=6, K=3, lengths=[383, 385],
         shared=True),
    dict(B=3, Hkv=2, rep=2, hd=32, P=4, K=4, lengths=[1, 256, 512]),
    dict(B=2, Hkv=1, rep=16, hd=256, P=3, K=2, lengths=[200, 300]),
], ids=["serving", "shared", "k_eq_p_hd32", "rep16_hd256"])
def test_kernel_matches_plain(gpu, flavor, shape):
    q, kp, vp, idx, length = _case(gpu, **shape)
    kwargs = {}
    if flavor == "int8":
        kp, ks = quantized_kv.quantize_pages(kp)
        vp, vs = quantized_kv.quantize_pages(vp)
        kwargs = dict(k_scale=ks, v_scale=vs)
    sectored_attention.reset_launches()
    out, mass = sectored_attention.sectored_attention_paged(
        q, kp, vp, idx, length, **kwargs)
    torch.cuda.synchronize()
    assert sectored_attention.launches[flavor] == 1
    want_out, want_mass = sectored_attention.sectored_attention_paged_ref(
        q, kp, vp, idx, length, **kwargs)
    torch.testing.assert_close(out, want_out, rtol=0, atol=OUT_TOL[flavor])
    torch.testing.assert_close(mass, want_mass, rtol=0, atol=MASS_TOL)


def test_kernel_rejects_what_it_does_not_take(gpu):
    q, kp, vp, idx, length = _case(gpu, 1, 1, 2, 128, 2, 1, [10])
    with pytest.raises(TypeError):
        sectored_attention.sectored_attention_paged(q.float(), kp, vp, idx,
                                                    length)
    with pytest.raises(ValueError, match="contiguous"):
        sectored_attention.sectored_attention_paged(
            q, kp.transpose(1, 2).contiguous().transpose(1, 2), vp, idx,
            length)
    with pytest.raises(ValueError):
        sectored_attention.sectored_attention_paged(q, kp, vp, idx.cpu(),
                                                    length)


def test_fused_step_close_to_dispatch(gpu):
    cfg = configs.get("yi-6b").reduced(n_layers=2, d_model=256, n_heads=8,
                                       n_kv_heads=2, d_ff=512, vocab=512,
                                       head_dim=128)
    params = model.init_params(cfg, seed=0, device=gpu)
    state = sectored_decode.init_state(cfg, 2, 768, device=gpu)
    P = state.table.shape[-1]
    gen = torch.Generator(device=gpu)
    gen.manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 700), generator=gen, device=gpu,
                         dtype=torch.int32)
    for i in range(toks.shape[1]):
        _, state = sectored_decode.sectored_decode_step(
            params, cfg, state, toks[:, i:i + 1], P)
    sectored_attention.reset_launches()
    out = {}
    for kernel in ("dispatch", "fused", "fused_q8"):
        out[kernel] = sectored_decode.sectored_decode_step(
            params, cfg, state.clone(), toks[:, -1:], 2, probe=True,
            kernel=kernel)
    assert sectored_attention.launches == {"bf16": 2, "int8": 2}
    (ld, sd), (lf, sf), (lq, _) = out.values()
    torch.testing.assert_close(lf.float(), ld.float(), rtol=0, atol=0.1)
    torch.testing.assert_close(sf.table, sd.table, rtol=0, atol=1e-3)
    lp = (torch.log_softmax(lq.float(), -1)
          - torch.log_softmax(ld.float(), -1)).abs().max().item()
    assert lp <= quantized_kv.LOGPROB_TOL


# -- the kernels.ops kernels (see chip_smoke.HEAD_MAJOR_TOL / FLASH_TOL) ------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
@pytest.mark.parametrize("W", [128, 3])
@pytest.mark.parametrize("mask_dtype", [torch.uint32, torch.int32,
                                        torch.int64])
def test_vbl_kernel_bitwise(gpu, dtype, W, mask_dtype):
    gen = torch.Generator(device=gpu)
    gen.manual_seed(2)
    data = torch.randn((300, 8, W), generator=gen, device=gpu)
    data = (data * 1000).to(dtype) if dtype == torch.int32 else data.to(dtype)
    masks = torch.randint(0, 2 ** 32, (300,), generator=gen, device=gpu,
                          dtype=torch.int64)
    masks[:3] = torch.tensor([0xFF, 0x00, 0xFFFFFF00], device=gpu)
    masks = masks.to(mask_dtype)
    ops.reset_launches()
    out, counts = ops.vbl_gather(data, masks)
    torch.cuda.synchronize()
    assert vbl_gather.launches == {"vbl_gather": 1}
    want, want_counts = vbl_gather.vbl_gather_ref(data, masks)
    view = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(out.view(view), want.view(view))
    assert torch.equal(counts, want_counts)
    assert counts[:3].tolist() == [8, 0, 0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("page,P,K,lengths,shared", [
    (128, 16, 5, [1500, 1, 0, 2048], False),
    (128, 6, 3, [383, 385], True),
    (256, 4, 4, [1024, 255], False),
], ids=["decode", "shared", "page256_k_eq_p"])
def test_head_major_kernel_matches_plain(gpu, dtype, page, P, K, lengths,
                                         shared):
    gen = torch.Generator(device=gpu)
    gen.manual_seed(3)
    B, Hkv, rep, hd = len(lengths), 2, 8, 128
    q = torch.randn((B, Hkv, rep, hd), generator=gen, device=gpu).to(dtype)
    kp, vp = (torch.randn((B, Hkv, P, page, hd), generator=gen,
                          device=gpu).to(dtype) for _ in range(2))
    heads = 1 if shared else Hkv
    idx = torch.stack([torch.sort(torch.randperm(P, generator=gen,
                                                 device=gpu)[:K]).values
                       for _ in range(B * heads)]).reshape(B, heads, K)
    args = (q, kp, vp, idx.to(torch.int32),
            torch.tensor(lengths, dtype=torch.int32, device=gpu))
    ops.reset_launches()
    out = ops.sectored_attention(*args)
    torch.cuda.synchronize()
    flavor = "f32" if dtype == torch.float32 else "bf16"
    assert sectored_attention.head_major_launches[flavor] == 1
    want = sectored_attention.sectored_attention_ref(*args)
    torch.testing.assert_close(out, want, rtol=0, atol=1e-5)
    if 0 in lengths:
        assert not out[lengths.index(0)].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 1, 128, 64), (2, 2, 256, 64),
                                   (1, 4, 256, 128), (2, 1, 512, 32),
                                   (1, 2, 32, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_matches_plain(gpu, dtype, shape, causal):
    gen = torch.Generator(device=gpu)
    gen.manual_seed(4)
    q, k, v = (torch.randn(shape, generator=gen, device=gpu).to(dtype)
               for _ in range(3))
    ops.reset_launches()
    out = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    flavor = "f32" if dtype == torch.float32 else "bf16"
    assert flash_attention.launches[flavor] == 1 and out.dtype == dtype
    want = flash_attention.flash_attention_ref(q, k, v, causal)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)


def test_ops_kernels_reject_what_they_do_not_take(gpu):
    q = torch.randn((1, 1, 64, 64), device=gpu)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q.transpose(2, 3), q, q)
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.flash_attention(q, q.cpu(), q)
    data = torch.randn((4, 8, 16), device=gpu)
    masks = torch.zeros(4, dtype=torch.int32, device=gpu)
    with pytest.raises(ValueError, match="contiguous"):
        ops.vbl_gather(data.transpose(0, 2).contiguous().transpose(0, 2),
                       masks)
    kp = torch.randn((1, 1, 2, 16, 32), device=gpu)
    idx = torch.zeros((1, 1, 1), dtype=torch.int32, device=gpu)
    length = torch.ones(1, dtype=torch.int32, device=gpu)
    with pytest.raises(ValueError, match="contiguous"):
        ops.sectored_attention(torch.randn((1, 1, 2, 32), device=gpu), kp,
                               kp.transpose(2, 3).contiguous()
                               .transpose(2, 3), idx, length)


def _quantize(kp, vp, flavor):
    if flavor == "bf16":
        return kp, vp, {}
    kq, ks = quantized_kv.quantize_pages(kp)
    vq, vs = quantized_kv.quantize_pages(vp)
    return kq, vq, dict(k_scale=ks, v_scale=vs)


@pytest.mark.parametrize("flavor", ["bf16", "int8"])
@pytest.mark.parametrize("shape", [
    # K = P = 24 at ragged lengths: the largest cluster slice (384 slots)
    dict(B=4, Hkv=4, rep=8, hd=128, P=24, K=24,
         lengths=[1, 1000, 2049, 3072]),
    # one page, one valid token
    dict(B=2, Hkv=4, rep=8, hd=128, P=24, K=1, lengths=[1, 1]),
    # the serving shape: 5 pages of 24
    dict(B=4, Hkv=4, rep=8, hd=128, P=24, K=5,
         lengths=[769, 800, 700, 896]),
], ids=["k_eq_p_24_ragged", "k1_len1", "serving"])
def test_paged_kernel_one_launch_deterministic(gpu, flavor, shape):
    """The cluster kernel vs plain, one launch per call, and two calls on
    the same inputs bitwise equal (partial sums in a fixed order)."""
    q, kp, vp, idx, length = _case(gpu, **shape, seed=5)
    if shape["K"] == 1:  # the page that holds token 0
        idx = torch.zeros_like(idx)
    kp, vp, kwargs = _quantize(kp, vp, flavor)
    sectored_attention.reset_launches()
    out1, mass1 = sectored_attention.sectored_attention_paged(
        q, kp, vp, idx, length, **kwargs)
    out2, mass2 = sectored_attention.sectored_attention_paged(
        q, kp, vp, idx, length, **kwargs)
    torch.cuda.synchronize()
    assert sectored_attention.launches[flavor] == 2
    assert torch.equal(out1, out2) and torch.equal(mass1, mass2)
    want_out, want_mass = sectored_attention.sectored_attention_paged_ref(
        q, kp, vp, idx, length, **kwargs)
    torch.testing.assert_close(out1, want_out, rtol=0, atol=OUT_TOL[flavor])
    torch.testing.assert_close(mass1, want_mass, rtol=0, atol=MASS_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", flash_attention.HEAD_DIMS)
@pytest.mark.parametrize("S", [32, 128, 2048])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_every_width(gpu, dtype, hd, S, causal):
    gen = torch.Generator(device=gpu)
    gen.manual_seed(6)
    q, k, v = (torch.randn((1, 2, S, hd), generator=gen,
                           device=gpu).to(dtype) for _ in range(3))
    ops.reset_launches()
    out = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    flavor = "f32" if dtype == torch.float32 else "bf16"
    assert flash_attention.launches[flavor] == 1 and out.dtype == dtype
    want = flash_attention.flash_attention_ref(q, k, v, causal)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)


def _head_major_case(gpu, dtype, B, Hkv, rep, hd, page, P, K, lengths,
                     idx=None, seed=7):
    gen = torch.Generator(device=gpu)
    gen.manual_seed(seed)
    q = torch.randn((B, Hkv, rep, hd), generator=gen, device=gpu).to(dtype)
    kp, vp = (torch.randn((B, Hkv, P, page, hd), generator=gen,
                          device=gpu).to(dtype) for _ in range(2))
    if idx is None:
        idx = torch.stack([torch.sort(torch.randperm(
            P, generator=gen, device=gpu)[:K]).values
            for _ in range(B * Hkv)]).reshape(B, Hkv, K)
    else:
        idx = torch.tensor(idx, device=gpu)
    return (q, kp, vp, idx.to(torch.int32),
            torch.tensor(lengths, dtype=torch.int32, device=gpu))


def _misaligned(t):
    """A contiguous copy of ``t`` whose data starts 4 bytes past a 16-byte
    boundary."""
    flat = torch.empty(t.numel() + 16 // t.element_size(), dtype=t.dtype,
                       device=t.device)
    out = flat[4 // t.element_size():][:t.numel()].view(t.shape)
    out.copy_(t)
    return out


HEAD_MAJOR_CASES = {
    "hd32": dict(B=2, Hkv=2, rep=8, hd=32, page=128, P=6, K=4,
                 lengths=[700, 129]),
    "hd64": dict(B=2, Hkv=2, rep=4, hd=64, page=128, P=6, K=4,
                 lengths=[700, 129]),
    # 16 query rows: two row groups a block
    "hd256_rep16": dict(B=2, Hkv=2, rep=16, hd=256, page=128, P=6, K=4,
                        lengths=[700, 129]),
    "k_eq_p": dict(B=2, Hkv=2, rep=8, hd=128, page=128, P=6, K=6,
                   lengths=[768, 300]),
    "length_0": dict(B=2, Hkv=2, rep=8, hd=128, page=128, P=6, K=3,
                     lengths=[0, 500]),
    # page 2 twice in both heads of both sequences (pages 6 and 7 lie
    # wholly past both lengths)
    "repeated_page": dict(B=2, Hkv=2, rep=8, hd=128, page=128, P=8, K=3,
                          lengths=[700, 768],
                          idx=[[[2, 2, 4], [0, 2, 2]],
                               [[2, 2, 5], [2, 3, 2]]]),
    # 16 blocks of 256 slots too large to load whole: the tiled walk
    "tiled": dict(B=2, Hkv=2, rep=8, hd=256, page=256, P=16, K=16,
                  lengths=[4096, 2500]),
    # 64 query rows over 512-slot slices: scores recomputed per tile
    "tiled_recompute": dict(B=1, Hkv=1, rep=64, hd=256, page=256, P=32,
                            K=32, lengths=[8000]),
    # 72 query rows: a second block row (grid y)
    "rep72": dict(B=1, Hkv=2, rep=72, hd=128, page=128, P=4, K=3,
                  lengths=[500]),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(HEAD_MAJOR_CASES))
def test_head_major_one_launch_deterministic(gpu, dtype, name):
    """The cluster kernel vs plain within 1e-5 (chip_smoke.HEAD_MAJOR_TOL),
    one launch per call, two calls on the same inputs bitwise equal."""
    spec = HEAD_MAJOR_CASES[name]
    args = _head_major_case(gpu, dtype, **spec)
    flavor = "f32" if dtype == torch.float32 else "bf16"
    ops.reset_launches()
    out1 = ops.sectored_attention(*args)
    out2 = ops.sectored_attention(*args)
    torch.cuda.synchronize()
    assert sectored_attention.head_major_launches[flavor] == 2
    assert torch.equal(out1, out2)
    want = sectored_attention.sectored_attention_ref(*args)
    torch.testing.assert_close(out1, want, rtol=0, atol=1e-5)
    if 0 in spec["lengths"]:
        assert not out1[spec["lengths"].index(0)].any()
    if name == "repeated_page":
        # each repeat counted: the second 2 of each row replaced by a page
        # past the length (page 2 taken once) gives another output
        q, kp, vp, _, length = args
        once = torch.tensor([[[2, 7, 4], [0, 2, 7]], [[2, 7, 5], [2, 3, 7]]],
                            dtype=torch.int32, device=gpu)
        out_once = ops.sectored_attention(q, kp, vp, once, length)
        torch.testing.assert_close(
            out_once, sectored_attention.sectored_attention_ref(
                q, kp, vp, once, length), rtol=0, atol=1e-5)
        assert (out1 - out_once).abs().max() > 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_major_misaligned_cache(gpu, dtype):
    """K and V not 16-byte aligned: no bulk copies, the same result."""
    args = list(_head_major_case(gpu, dtype, **HEAD_MAJOR_CASES["k_eq_p"]))
    want = sectored_attention.sectored_attention_ref(*args)
    args[1], args[2] = _misaligned(args[1]), _misaligned(args[2])
    assert args[1].data_ptr() % 16 and args[1].is_contiguous()
    out = ops.sectored_attention(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, want, rtol=0, atol=1e-5)


# -- captured CUDA graphs of the serving path ---------------------------------

GRAPH_CFG = dict(n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, d_ff=512,
                 vocab=512, head_dim=128)


def _graph_backends(gpu, kernel):
    """(cfg, backend with graphs, eager backend) over the same weights."""
    cfg = configs.get("yi-6b").reduced(**GRAPH_CFG)
    params = model.init_params(cfg, seed=0, device=gpu)
    kw = dict(params=params, seq_len=768, min_topk=1, kernel=kernel,
              device=gpu)
    return (cfg, sectored_decode.make_serving_fns(cfg, **kw),
            sectored_decode.make_serving_fns(cfg, graphs=False, **kw))


def _equal_trees(a, b):
    return all(torch.equal(x, y) for x, y in zip(
        graphs.leaves(a), graphs.leaves(b), strict=True))


def _wave_state(gpu, cfg, backend, lengths=(126, 127, 300, 383)):
    """A wave buffer of 4 slots prefilled to ``lengths`` (two of them two
    and one token below a page edge), and the tokens."""
    gen = torch.Generator(device=gpu)
    gen.manual_seed(4)
    state = None
    for slot, n in enumerate(lengths):
        prompt = torch.randint(0, cfg.vocab, (1, n), generator=gen,
                               device=gpu, dtype=torch.int32)
        _, row = backend.prefill_fn(prompt)
        if state is None:
            state = row.zeros_batch(len(lengths))
        state.set_row(slot, row)
    token = torch.randint(0, cfg.vocab, (len(lengths), 1), generator=gen,
                          device=gpu, dtype=torch.int32)
    return state, token


@pytest.mark.parametrize("mode", ["exact", "fused", "fused_q8"])
def test_replay_bitwise_eager(gpu, mode):
    """Steps and fused waves replayed from captured graphs equal the eager
    ones bitwise (logits, K/V, lengths, table, position, tokens, sampler
    rows) over 4 waves that cross a page boundary; the paged kernel's
    launches are counted through the replays."""
    cfg, bg, be = _graph_backends(gpu, "fused" if mode == "exact" else mode)
    state, token = _wave_state(gpu, cfg, be)
    pick = (lambda b: b.decode_fn) if mode == "exact" else (
        lambda b: b.sectored_fn_for(None))
    sg, se = state.clone(), state.clone()
    tok = token
    sectored_attention.reset_launches()
    for _ in range(4):
        lg, sg_out = pick(bg)(sg, tok)
        le, se = pick(be)(se, tok)
        assert sg_out is sg
        assert torch.equal(lg, le) and _equal_trees(sg, se)
        tok = torch.argmax(le.float(), -1, keepdim=True).to(torch.int32)
    flavor = {"fused": "bf16", "fused_q8": "int8"}.get(mode)
    if flavor is not None:  # 4 replays + 4 eager steps, one launch a layer
        assert sectored_attention.launches[flavor] == 8 * cfg.n_layers
    assert int(sg.kv.length.min()) > 128  # crossed the first page edge

    wg, we = make_fused_wave(pick(bg)), make_fused_wave(pick(be))
    assert isinstance(wg, graphs.CapturedStep)
    (sg, rg), (se, re_) = [(state.clone(), SamplerRows.init(4, device=gpu))
                           for _ in range(2)]
    tg = te = token
    for _ in range(4):
        tg = wg(sg, tg, rg).clone()
        te = we(se, te, re_)
        assert torch.equal(tg, te)
        assert _equal_trees((sg, rg), (se, re_))


def test_prefill_graph_bitwise_eager(gpu):
    """Prompts of every length replay one batch-1 graph over one static
    state, and equal the eager token loop bitwise."""
    cfg, bg, be = _graph_backends(gpu, "fused")
    gen = torch.Generator(device=gpu)
    gen.manual_seed(5)
    for n in (130, 40, 1):
        prompt = torch.randint(0, cfg.vocab, (1, n), generator=gen,
                               device=gpu, dtype=torch.int32)
        lg, sg = bg.prefill_fn(prompt)
        le, se = be.prefill_fn(prompt)
        assert torch.equal(lg, le) and _equal_trees(sg, se)
    assert list(bg._prefill_graphs) == [1]


def test_capture_leaves_the_live_state(gpu):
    """Warm-up and capture write nothing the caller holds: the warm-up runs
    on a scratch copy and a capture runs no kernel. The first replay then
    takes the state exactly one step on."""
    cfg, bg, be = _graph_backends(gpu, "fused")
    state, token = _wave_state(gpu, cfg, be)
    before = state.clone()
    step = graphs.CapturedStep(bg.sectored_fn_for(None).step_, pool=bg.pool)
    sectored_attention.reset_launches()
    step._capture(state, token, ())
    torch.cuda.synchronize()
    assert _equal_trees(state, before)
    assert sectored_attention.launches["bf16"] == 0  # neither is counted
    assert step.warmup_launches[0]["bf16"] == cfg.n_layers
    assert step.launches[0]["bf16"] == cfg.n_layers
    logits = step(state, token)
    want_logits, want = be.sectored_fn_for(None)(before, token)
    assert torch.equal(logits, want_logits) and _equal_trees(state, want)
    assert sectored_attention.launches["bf16"] == 2 * cfg.n_layers


def test_uncapturable_step_raises(gpu):
    """A body that syncs with the host cannot be captured: the call raises,
    every time, and nothing runs it eagerly in the graph's place."""
    def body(state, token):
        state.add_(token * int(state.sum().item()))
        return state

    state = torch.ones(4, device=gpu)
    step = graphs.CapturedStep(body)
    for _ in range(2):
        with pytest.raises(RuntimeError):
            step(state, torch.ones(4, device=gpu))
        torch.cuda.synchronize()
        assert step.graph is None
        assert torch.equal(state, torch.ones(4, device=gpu))
    assert torch.equal(torch.ones(4, device=gpu) * 2,
                       torch.full((4,), 2.0, device=gpu))  # card still fine


SEEDS = (0, 1, 3, 2**31, 2**32 - 1)
POSITIONS = (0, 1, 2, 127, 4095)


def test_rng_on_card_bitwise_cpu(gpu):
    """Keys, 64,000 bits and uniforms per key on the card equal the CPU's
    (which tests/test_torch_sample.py ties to JAX) bitwise; the Gumbel
    draws are equal too, or within 4 ulps of max(1, |g|) where the
    card's log rounds differently."""
    seeds = torch.tensor(SEEDS).repeat_interleave(len(POSITIONS))
    pos = torch.tensor(POSITIONS, dtype=torch.int32).repeat(len(SEEDS))
    cpu = rng.token_key(seeds, pos)
    card = rng.token_key(seeds.to(gpu), pos.to(gpu))
    assert torch.equal(card.cpu(), cpu)
    assert torch.equal(rng.random_bits(card, 64000).cpu(),
                       rng.random_bits(cpu, 64000))
    assert torch.equal(rng.uniform(card, 64000).cpu().view(torch.int32),
                       rng.uniform(cpu, 64000).view(torch.int32))
    gc, gg = rng.gumbel(cpu, 64000).double(), rng.gumbel(card, 64000)
    err = (gg.cpu().double() - gc).abs() / gc.abs().clamp_min(1.0)
    assert float(err.max()) <= 4 * torch.finfo(torch.float32).eps


def test_sample_from_logits_card_vs_cpu(gpu):
    """Tokens drawn on the card equal the CPU's on the same logits, except
    where the two highest perturbed scores lie within 4 ulps."""
    gen = torch.Generator().manual_seed(6)
    specs = [SamplerSpec(temperature=t, top_k=k, top_p=p, seed=s)
             for t in (0.3, 1.0) for k in (0, 50) for p in (1.0, 0.9)
             for s in (0, 2**32 - 1)] + [None] * 4
    logits = torch.randn((len(specs), 64000), generator=gen) * 2.5
    rows = SamplerRows.from_specs(specs, list(range(len(specs))))
    cpu = sample_from_logits(logits, rows)
    card = sample_from_logits(logits.to(gpu), SamplerRows.from_specs(
        specs, list(range(len(specs))), device=gpu)).cpu()
    for i in torch.nonzero(cpu != card).flatten().tolist():
        row = SamplerRows.from_specs([specs[i]], [i])
        scaled = kernel._mask_top_p(kernel._mask_top_k(
            logits[i:i + 1] / specs[i].temperature, row.top_k), row.top_p)
        z = (scaled + rng.gumbel(rng.token_key(row.seed, row.pos),
                                 64000))[0]
        top = torch.topk(z, 2).values
        assert float(top[0] - top[1]) <= 4 * torch.finfo(
            torch.float32).eps * max(1.0, float(top[0].abs()))


def _mixed_specs():
    return [SamplerSpec(temperature=0.8, top_k=50, top_p=0.9, seed=r)
            if r % 2 == 0 else None for r in range(4)]


def _serve(sess, cfg, specs, lengths, new=6):
    gen = torch.Generator().manual_seed(9)
    handles = [sess.submit(Request(
        r, torch.randint(0, cfg.vocab, (n,), generator=gen).numpy().astype(
            "int32"), max_new_tokens=new, sampler=s))
        for r, (n, s) in enumerate(zip(lengths, specs))]
    sess.run_until_drained()
    return ([h.peek() for h in handles], [h.logprobs() for h in handles],
            [t.cpu() for t in graphs.leaves((sess.batched,
                                             sess._sampler_rows))])


@pytest.mark.parametrize("path", ["fused", "dense"])
def test_sampled_and_greedy_waves_replay_bitwise_eager(gpu, path):
    """A session whose waves replay captured graphs (the greedy flavor,
    then the sampled one with greedy and sampled requests sharing it)
    equals the eager session bitwise: tokens, logprobs, final wave buffer
    and sampler rows; greedy requests keep their streams."""
    cfg = configs.get("yi-6b").reduced(**GRAPH_CFG)
    params = model.init_params(cfg, seed=0, device=gpu)
    lengths = (126, 127, 300, 383)
    out = {}
    for specs_name, specs in (("greedy", [None] * 4),
                              ("mixed", _mixed_specs())):
        for g in (True, False):
            sess = launch_serve.build_session(
                cfg, params, true_sectored=path == "fused",
                kernel="fused" if path == "fused" else "dispatch",
                policy="sectored" if path == "fused" else "dense",
                seq_len=768, device=gpu, graphs=g)
            out[specs_name, g] = _serve(sess, cfg, specs, lengths)
            waves = list(sess._wave_cache.values())
            assert all(isinstance(w, graphs.CapturedStep) == g
                       for w in waves)
            assert [k[1] for k in sess._wave_cache] == [
                specs_name == "mixed"]
        (tg, lg, fg), (te, le, fe) = out[specs_name, True], out[
            specs_name, False]
        assert tg == te and lg == le
        assert all(torch.equal(a, b) for a, b in zip(fg, fe))
    greedy, mixed = out["greedy", True][0], out["mixed", True][0]
    assert greedy[1] == mixed[1] and greedy[3] == mixed[3]
