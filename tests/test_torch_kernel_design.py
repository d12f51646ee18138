"""What the Hopper kernels' designs add on the Python side, checked on the
CPU: the paged kernel's cluster plan, and the bf16 flash kernel's split
of p into two bf16 terms.

* ``cluster_plan`` cuts the K * page token slots of one (batch, kv-head)
  into C contiguous slices, one per block of a thread-block cluster: every
  slot must fall in exactly one slice, every block must get a slot, and a
  block's shared memory must fit on the card.
* The bf16 flash kernel computes P V on bf16 tensor cores while the
  reference keeps p in f32 (``src/repro/kernels/flash_attention.py``): it
  splits p into ``hi = bf16(p)`` and ``lo = bf16(p - hi)`` and adds
  ``hi V + lo V`` in f32. A plain-torch emulation of that arithmetic (64-key
  tiles, online max and sum, both products accumulated in f32) is held to
  the reference's f32 ``flash_attention_ref`` within 1e-5 of the output's
  scale; rounding p to bf16 once, as ``attention._attend_blocked`` does,
  is not.
"""

import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread  # noqa: F401  (autouse)
from repro.kernels import ref as jref
from repro_torch.kernels import sectored_attention as tsa

NEG_INF = -1e30
# the split leaves out p - hi - lo, at most 2**-17 of p; the sums in
# another order add f32 ulps. Measured over the cases below: at most
# 2.2e-6 of the output scale split, 6.8e-4 to 1.6e-3 with bf16(p) once.
SPLIT_TOL = 1e-5


def _slices(C, chunk, n):
    return [(r * chunk, min((r + 1) * chunk, n)) for r in range(C)]


@pytest.mark.parametrize("rep,hd,itemsize", [
    (8, 128, 2), (8, 128, 1), (16, 256, 2), (2, 32, 1), (4, 64, 2)],
    ids=["yi6b_bf16", "yi6b_int8", "rep16_hd256", "rep2_hd32_int8",
         "rep4_hd64"])
@pytest.mark.parametrize("page", [1, 7, 128])
def test_cluster_plan_covers_every_slot_once(rep, hd, itemsize, page):
    for K in range(1, 24 * 128 // page + 1):
        n = K * page
        try:
            C, chunk = tsa.cluster_plan(K, page, rep, hd, itemsize)
        except ValueError:  # only where 16 slices cannot fit a block
            least = -(-n // tsa.CLUSTER_MAX_NONPORTABLE)
            assert tsa.paged_smem_bytes(rep, hd, K, least,
                                        itemsize) > tsa.SMEM_LIMIT
            continue
        assert 1 <= C <= tsa.CLUSTER_MAX_NONPORTABLE, (K, page, C)
        if C > tsa.CLUSTER_MAX:  # only where 8 slices cannot fit a block
            assert tsa.paged_smem_bytes(rep, hd, K, -(-n // tsa.CLUSTER_MAX),
                                        itemsize) > tsa.SMEM_LIMIT
        covered = np.zeros(n, np.int64)
        for lo, hi in _slices(C, chunk, n):
            assert lo < hi, f"empty block: K={K} page={page} C={C} {chunk}"
            covered[lo:hi] += 1
        assert (covered == 1).all(), (K, page, C, chunk)
        assert tsa.paged_smem_bytes(rep, hd, K, chunk,
                                    itemsize) <= tsa.SMEM_LIMIT


def test_cluster_plan_at_the_serving_shapes():
    # yi-6b serving: K = 5 pages of 128 -> 8 blocks of 80 slots; K = P =
    # 24 -> 8 blocks of 384 slots (96 KB each of bf16 K and V)
    assert tsa.cluster_plan(5, 128, 8, 128, 2) == (8, 80)
    assert tsa.cluster_plan(24, 128, 8, 128, 2) == (8, 384)
    assert tsa.cluster_plan(1, 128, 8, 128, 2) == (4, 32)
    assert tsa.cluster_plan(1, 1, 8, 128, 2) == (1, 1)


def test_cluster_plan_grows_to_16_then_raises():
    # 40 pages of 128 at rep 8, hd 128 bf16: 8 slices of 640 slots do not
    # fit a block (320 KB of K and V), 16 slices of 320 do
    C, chunk = tsa.cluster_plan(40, 128, 8, 128, 2)
    assert (C, chunk) == (16, 320)
    assert tsa.paged_smem_bytes(8, 128, 40, chunk, 2) <= tsa.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        tsa.cluster_plan(256, 128, 8, 128, 2)


def _flash_split(q, k, v, causal, split=True, tile=64):
    """The bf16 flash kernel's arithmetic in plain torch: f32 scores of
    bf16 inputs, online softmax over ``tile``-key tiles, P V as hi V + lo V
    (or, with ``split=False``, bf16(p) V)."""
    S, hd = q.shape[-2:]
    qf, kf, vf = q.float(), k.float(), v.float()
    scale = torch.tensor(1.0, dtype=torch.float32) / torch.sqrt(
        torch.tensor(float(hd), dtype=torch.float32))
    m = torch.full(q.shape[:-1] + (1,), NEG_INF)
    l = torch.zeros(q.shape[:-1] + (1,))
    acc = torch.zeros(q.shape[:-1] + (hd,))
    rows = torch.arange(S)[:, None]
    for k0 in range(0, S, tile):
        keys = torch.arange(k0, min(k0 + tile, S))[None, :]
        valid = (keys <= rows) if causal else torch.ones(S, keys.shape[1],
                                                         dtype=torch.bool)
        s = qf @ kf[..., k0:k0 + tile, :].transpose(-1, -2) * scale
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.where(valid, torch.exp(s - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        hi = p.to(torch.bfloat16).float()
        vt = vf[..., k0:k0 + tile, :]
        pv = hi @ vt
        if split:
            pv = pv + (p - hi).to(torch.bfloat16).float() @ vt
        acc = acc * alpha + pv
        m = m_new
    return acc / torch.clamp_min(l, 1e-30)


@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_hi_lo_split_keeps_f32_p(hd, causal):
    rng = np.random.default_rng(hd + causal)
    # bf16 values, held in f32 for the reference's f32 arithmetic
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 2, 256, hd)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(3))
    want = torch.from_numpy(np.array(jref.flash_attention_ref(
        *(t.float().numpy() for t in (q, k, v)), causal=causal)))
    scale = float(want.abs().max())
    err = float((_flash_split(q, k, v, causal) - want).abs().max()) / scale
    assert err <= SPLIT_TOL, f"hi/lo split: {err:.3g} of the output scale"
    once = float((_flash_split(q, k, v, causal, split=False)
                  - want).abs().max()) / scale
    assert once > 10 * SPLIT_TOL, f"bf16(p) once: only {once:.3g}"
