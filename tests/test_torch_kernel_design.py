"""What the Hopper kernels' designs add on the Python side, checked on the
CPU: the paged and head-major kernels' cluster plans, the head-major
kernel's order of sums, and the bf16 flash kernel's split of p into two
bf16 terms.

* ``cluster_plan`` cuts the K * page token slots of one (batch, kv-head)
  into C contiguous slices, one per block of a thread-block cluster: every
  slot must fall in exactly one slice, every block must get a slot, and a
  block's shared memory must fit on the card. ``head_major_plan`` does the
  same for the head-major kernel, and past what a block holds whole it
  walks the slice in tiles (``tile < chunk``).
* The head-major kernel adds its sums in another order than the
  reference: each block forms e against the exact global row max, its
  row sums and partial e V, and the blocks' partials are added in rank
  order. A plain-torch emulation of that order is held to the reference's
  ``sectored_attention_ref`` within 1e-6.
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
# f32 sums in another order; measured over the cases below: at most
# 3.3e-7 (outputs of size ~1)
ORDER_TOL = 1e-6


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


@pytest.mark.parametrize("itemsize", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("hd", [32, 64, 128, 256])
@pytest.mark.parametrize("page", [128, 256])
@pytest.mark.parametrize("rep", [8, 64])
def test_head_major_plan_covers_every_slot_once(itemsize, hd, page, rep):
    for K in range(1, 33):
        n = K * page
        C, chunk, tile = tsa.head_major_plan(K, page, rep, hd, itemsize)
        assert 1 <= C <= tsa.CLUSTER_MAX_NONPORTABLE, (K, C)
        assert 1 <= tile <= chunk, (K, chunk, tile)
        covered = np.zeros(n, np.int64)
        for lo, hi in _slices(C, chunk, n):
            assert lo < hi, f"empty block: K={K} C={C} chunk={chunk}"
            covered[lo:hi] += 1
        assert (covered == 1).all(), (K, C, chunk)
        smem, stages, _ = tsa.head_major_layout(rep, hd, itemsize, chunk,
                                                tile)
        assert smem <= tsa.SMEM_LIMIT and stages >= 1, (K, smem, stages)
        if tile < chunk:  # only where 16 whole slices cannot fit a block
            assert C == -(-n // -(-n // tsa.CLUSTER_MAX_NONPORTABLE))
            assert tsa.head_major_layout(rep, hd, itemsize, chunk,
                                         chunk)[0] > tsa.SMEM_LIMIT


def test_head_major_plan_at_its_shapes():
    # the decode shape: 8 blocks of 80 slots, loaded whole (K and V)
    for itemsize in (4, 2):
        assert tsa.head_major_plan(5, 128, 8, 128, itemsize) == (8, 80, 80)
    # f32, hd 256, page 256, K 16: 16 slices of 256 slots would need 512 KB
    # a block whole, so the block walks 32-slot tiles through 6 stages,
    # keeping the slice's scores
    C, chunk, tile = tsa.head_major_plan(16, 256, 8, 256, 4)
    assert (C, chunk, tile) == (16, 256, 32)
    assert tsa.head_major_layout(8, 256, 4, chunk, tile)[1:] == (6, True)
    # 64 query rows over 512-slot slices: the scores are recomputed per tile
    C, chunk, tile = tsa.head_major_plan(32, 256, 64, 256, 4)
    assert (C, chunk) == (16, 512) and tile < chunk
    assert tsa.head_major_layout(64, 256, 4, chunk, tile)[2] is False
    # every shape gets a plan, however long the pages
    C, chunk, tile = tsa.head_major_plan(1, 100_000, 64, 256, 4)
    assert C * chunk >= 100_000 and tile < chunk


def _head_major_in_blocks(q, kp, vp, idx, length, C, chunk):
    """The head-major kernel's order of sums in plain torch (f32): scores
    and the count mask, the exact global row max from the blocks' local
    maxima, then per block r (slots [r chunk, (r+1) chunk)) its e, row sums
    and partial e V, added in rank order."""
    B, Hkv, rep, hd = q.shape
    page, K = kp.shape[3], idx.shape[-1]
    n = K * page
    pages = idx.expand(B, Hkv, K).long()
    root = torch.sqrt(torch.tensor(float(hd), dtype=torch.float32))
    out = torch.zeros((B, Hkv, rep, hd))
    for b in range(B):
        for h in range(Hkv):
            ks = kp[b, h, pages[b, h]].reshape(n, hd)
            vs = vp[b, h, pages[b, h]].reshape(n, hd)
            pos = (pages[b, h][:, None] * page + torch.arange(page)).reshape(n)
            valid = pos < length[b]
            s = torch.where(valid, (q[b, h] @ ks.T) / root, NEG_INF)
            blocks = _slices(C, chunk, n)
            m = torch.stack([s[:, lo:hi].amax(-1) for lo, hi in blocks]).amax(0)
            num, den = torch.zeros((rep, hd)), torch.zeros(rep)
            for lo, hi in blocks:
                e = torch.where(valid[lo:hi], torch.exp(s[:, lo:hi]
                                                        - m[:, None]), 0.0)
                den = den + e.sum(-1)
                num = num + e @ vs[lo:hi]
            out[b, h] = num / torch.clamp_min(den, 1e-30)[:, None]
    return out


@pytest.mark.parametrize("page,P,K,lengths,shared", [
    (128, 16, 5, [1500, 1, 0, 2048], False),
    (128, 6, 3, [383, 385], True),
    (256, 4, 4, [1024, 255], False),
    (16, 12, 12, [150, 191], False),
], ids=["decode", "shared", "page256_k_eq_p", "many_blocks"])
def test_head_major_order_of_sums(page, P, K, lengths, shared):
    rng = np.random.default_rng(page + K)
    B, Hkv, rep, hd = len(lengths), 2, 8, 64
    q = rng.normal(size=(B, Hkv, rep, hd)).astype(np.float32)
    kp, vp = (rng.normal(size=(B, Hkv, P, page, hd)).astype(np.float32)
              for _ in range(2))
    heads = 1 if shared else Hkv
    idx = np.stack([np.sort(rng.permutation(P)[:K])
                    for _ in range(B * heads)]).reshape(B, heads, K)
    idx, length = idx.astype(np.int32), np.asarray(lengths, np.int32)
    want = torch.from_numpy(np.array(jref.sectored_attention_ref(
        q, kp, vp, idx, length)))
    C, chunk, _ = tsa.head_major_plan(K, page, rep, hd, 4)
    got = _head_major_in_blocks(*(torch.from_numpy(x) for x in
                                  (q, kp, vp, idx, length)), C, chunk)
    err = float((got - want).abs().max())
    assert err <= ORDER_TOL, f"blocks in rank order: {err:.3g}"
    if 0 in lengths:
        assert not got[lengths.index(0)].any()


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
