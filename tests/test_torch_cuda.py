"""repro_torch on the GPU: the CUDA kernel vs its plain version on the
same CUDA tensors, and the fused decode step vs the dispatch step.

Every test here needs a CUDA GPU and skips without one. This file imports
neither JAX nor the JAX package, so it runs on a machine with only
PyTorch: ``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
"""

import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import quantized_kv, sectored_attention
from repro_torch.models import model
from repro_torch.runtime import sectored_decode

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
