"""Grouped-query attention (counterpart of the JAX package's
``models/attention.py``): ``qkv``, full causal ``attend`` (prefill) and its
blocked form, ``KVCache``, ``init_cache`` and one-token ``decode_attend``.
Everything here is plain torch, as the reference leaves it to XLA: no
kernel and no SDPA.

``tp`` (a ``parallel.tensor.TP``; the default ``tensor.UNSPLIT`` runs
every product whole) makes the parameters the rank's blocks and runs
the partitioned program: where ``wq`` splits its heads or ``wo`` its
head rows, the rank's attention core runs its block of the query
heads, each paired with its kv head ``h // (H / Hkv)`` as
:func:`_expand_kv` pairs them, and ``wo``'s partial products are summed
over 'model'. K/V split over kv heads stay local where those are the
rank's own; K/V made whole (a whole leaf, a split contraction summed, a
split head dim gathered) give the rank its heads' rows. Otherwise the
core runs on every head of every rank. The decode cache holds every kv
head; the new row is gathered whole before the append. A mesh's decode
step hands each layer its block of a cache split over the sequence
(:class:`KVBlock`, ``train.step.gathered_state``): the append writes
the rank's rows and the core reads the sequence gathered whole.

All shapes: x (B, S, D); q (B, S, H, hd); kv (B, S, Hkv, hd).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.models import layers
from repro_torch.parallel.tensor import UNSPLIT, heads_local

NEG_INF = -1e30


def init_attention(gen, cfg, dtype, device, lead=()) -> dict:
    d, hd = cfg.d_model, cfg.head_dim_
    h, hkv = cfg.n_heads, cfg.n_kv_heads
    s = d ** -0.5
    n = layers._normal
    p = dict(
        wq=n(gen, (*lead, d, h, hd), dtype, device, s),
        wk=n(gen, (*lead, d, hkv, hd), dtype, device, s),
        wv=n(gen, (*lead, d, hkv, hd), dtype, device, s),
        wo=n(gen, (*lead, h, hd, d), dtype, device, s),
    )
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((*lead, h, hd), dtype=dtype, device=device)
        p["bk"] = torch.zeros((*lead, hkv, hd), dtype=dtype, device=device)
        p["bv"] = torch.zeros((*lead, hkv, hd), dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((*lead, hd), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((*lead, hd), dtype=dtype, device=device)
    return p


def qkv(params: dict, cfg, x: torch.Tensor, positions: torch.Tensor,
        tp=UNSPLIT):
    """Projections, biases, q/k norms and RoPE: ``(q, k, v)``. ``k`` and
    ``v`` are whole (every kv head) and ``q`` is the rank's block of
    query heads where the core splits them (:func:`_split_qkv`)."""
    q, k, v, _, kv_local = _split_qkv(params, cfg, x, positions, tp)
    if kv_local:
        k, v = tp.gather(k, -2), tp.gather(v, -2)
    return q, k, v


def _split_qkv(params: dict, cfg, x: torch.Tensor, positions, tp):
    """The partitioned :func:`qkv`: ``(q, k, v, local, kv_local)``. The
    core is split (``local``) where the heads divide over 'model' and
    ``wq`` splits its heads or ``wo`` its head rows; ``q`` is then the
    rank's block of heads, else every head. ``k``/``v`` are the rank's
    block of kv heads where ``kv_local`` (split so by their leaves),
    else whole and replicated."""
    heads = x.ndim - 1  # the heads dim of (..., H, hd)
    lq, lk, lv = tp.land("wq"), tp.land("wk"), tp.land("wv")
    local = heads_local(cfg, tp)
    xc = tp.copy_for(x, lq, lk, lv)
    q, qd = tp.linear(x, params["wq"], lq, copied=xc)
    k, kd = tp.linear(x, params["wk"], lk, copied=xc)
    v, vd = tp.linear(x, params["wv"], lv, copied=xc)
    q = tp.reform(q, qd, heads if local else None)
    kv_local = local and kd == heads and vd == heads
    k = tp.reform(k, kd, heads if kv_local else None)
    v = tp.reform(v, vd, heads if kv_local else None)

    def bias(name, is_local):
        """A (H, hd) bias in the form of its projection."""
        return tp.reform(params[name], tp.land(name).dim,
                         0 if is_local else None)

    if cfg.qkv_bias:
        q = q + bias("bq", local)
        k = k + bias("bk", kv_local)
        v = v + bias("bv", kv_local)
    if cfg.qk_norm:
        # a replicated scale read by local heads: its gradient is summed
        q = layers.rms_norm(q, tp.copy(params["q_norm"]) if local
                            else params["q_norm"], cfg.norm_eps)
        k = layers.rms_norm(k, tp.copy(params["k_norm"]) if kv_local
                            else params["k_norm"], cfg.norm_eps)
    q = layers.apply_rope(q, positions, cfg.rope)
    k = layers.apply_rope(k, positions, cfg.rope)
    return q, k, v, local, kv_local


def _core_kv(tp, cfg, k: torch.Tensor, local: bool, kv_local: bool):
    """K (or V) as the core reads it: every kv head, or for a split
    core the kv heads of the rank's query heads (the rank's block where
    the kv heads divide over 'model', else each query head's own, so
    that query head ``j`` pairs with row ``j // (rows' repeat)``)."""
    if not local or kv_local:
        return k
    if cfg.n_kv_heads % tp.size == 0:
        return tp.scatter(k, -2)
    h0, h1 = tp.block(cfg.n_heads)
    rep = cfg.n_heads // cfg.n_kv_heads
    idx = torch.arange(h0, h1, device=k.device) // rep
    return tp.copy(k)[..., idx, :]


def out_project(out: torch.Tensor, wo: torch.Tensor, tp=UNSPLIT,
                local: bool = False) -> torch.Tensor:
    """``wo``'s product of the core's output ``out`` (B, S, H, hd), one
    product of the flattened heads, whole on every rank; ``local``:
    ``out`` holds the rank's block of the heads."""
    y, yd = tp.linear(out, wo, tp.land("wo"), 2,
                      x_dim=0 if local else None)
    return tp.full(y, yd)


def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, Hkv, hd) -> (B, S, H, hd), each kv head repeated H/Hkv
    times."""
    return torch.repeat_interleave(k, n_heads // k.shape[2], dim=2)


def attend(params: dict, cfg, x: torch.Tensor, positions: torch.Tensor,
           window: int = 0, tp=UNSPLIT) -> torch.Tensor:
    """Causal (optionally sliding-window) full attention: x (B, S, D),
    positions (B, S) -> (B, S, D).

    As the reference: bf16 scores (one bf16 product, then f32), an f32
    softmax cast to ``x.dtype`` before P·V. ``cfg.blocked_attention``
    (without a window) streams :func:`_attend_blocked` instead. ``tp``:
    see the module docstring.
    """
    q, k, v, local, kv_local = _split_qkv(params, cfg, x, positions, tp)
    k = _core_kv(tp, cfg, k, local, kv_local)
    v = _core_kv(tp, cfg, v, local, kv_local)
    return out_project(_core(cfg, q, k, v, positions, window),
                       params["wo"], tp, local)


def _core(cfg, q, k, v, positions, window: int) -> torch.Tensor:
    """Attention of q (B, S, H, hd) over k/v (B, S, G, hd), query head
    ``j`` paired with kv row ``j // (H / G)``: (B, S, H, hd)."""
    x_dtype = q.dtype
    if getattr(cfg, "blocked_attention", False) and window == 0:
        return _attend_blocked(cfg, q, k, v, positions)
    kf = _expand_kv(k, q.shape[2])
    vf = _expand_kv(v, q.shape[2])
    # (B, H, S, hd) @ (B, H, hd, S): einsum("bqhk,bshk->bhqs")
    scores = torch.matmul(q.transpose(1, 2),
                          kf.permute(0, 2, 3, 1)).float()
    scores = scores / torch.sqrt(
        torch.full((), cfg.head_dim_, dtype=torch.float32, device=q.device))
    qpos = positions[:, :, None]
    kpos = positions[:, None, :]
    mask = kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    scores = torch.where(mask[:, None], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(x_dtype)
    return torch.matmul(w, vf.transpose(1, 2)).transpose(1, 2)


def _attend_blocked(cfg, q, k, v, positions, block: int = 512):
    """Flash-style blocked causal attention in plain torch: KV blocks of
    ``block`` tokens streamed with a running max and sum, so no (S x S)
    score tensor exists. Query head ``j`` reads kv row ``j // (H / G)``
    of the G rows given. bf16 operands with f32 products and sums; ``p``
    is cast to the V dtype before P·V, as the reference does. Needs
    ``S % block == 0``, as the reference's reshape does.

    q (B, S, H, hd), k / v (B, S, Hkv, hd) -> (B, S, H, hd) in q's dtype.
    """
    B, S, H, hd = q.shape
    if S % block:
        raise ValueError(f"blocked attention needs S % {block} == 0, got "
                         f"S={S}")
    G = k.shape[2]
    qg = q.reshape(B, S, G, H // G, hd).float()
    scale = 1.0 / torch.sqrt(torch.full((), hd, dtype=torch.float32,
                                        device=q.device))
    m = torch.full((B, S, G, H // G), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, S, G, H // G, hd), dtype=torch.float32,
                      device=q.device)
    for start in range(0, S, block):
        kblk = k[:, start:start + block].float()
        vblk = v[:, start:start + block]
        s_ = torch.einsum("bsgrk,bcgk->bsgrc", qg, kblk) * scale
        kpos = start + torch.arange(block, device=q.device)
        mask = (kpos[None, None, :] <= positions[:, :, None])[:, :, None,
                                                              None, :]
        s_ = torch.where(mask, s_, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s_, dim=-1))
        p = torch.where(mask, torch.exp(s_ - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + torch.sum(p, dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bsgrc,bcgk->bsgrk", p.to(vblk.dtype).float(), vblk.float())
        m = m_new
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.reshape(B, S, H, hd).to(q.dtype)


@dataclasses.dataclass
class KVCache:
    """Dense decode cache: k/v (B, S_max, Hkv, hd), length (B,) int32."""

    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor

    #: the sequence row this cache's row 0 holds (:class:`KVBlock`)
    start = 0

    def whole(self):
        """``(k, v)`` over the whole sequence."""
        return self.k, self.v


@dataclasses.dataclass
class KVBlock(KVCache):
    """A mesh rank's block of a KV cache split over its sequence: rows
    ``[start, start + n)`` of every sequence. An append writes the new
    row where it falls in the block; :meth:`whole` gathers every rank's
    block (``gather(t)``)."""

    start: int = 0
    gather: Callable = None

    def whole(self):
        return self.gather(self.k), self.gather(self.v)


def init_cache(cfg, batch: int, seq_len: int, dtype=torch.bfloat16,
               device=None) -> KVCache:
    hkv, hd = cfg.n_kv_heads, cfg.head_dim_
    return KVCache(
        k=torch.zeros((batch, seq_len, hkv, hd), dtype=dtype, device=device),
        v=torch.zeros((batch, seq_len, hkv, hd), dtype=dtype, device=device),
        length=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def append_kv(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor):
    """Write each sequence's new K/V row at ``cache.length`` IN PLACE.

    The reference appends with a one-hot ``where`` (a scatter would
    replicate a sharded cache under SPMD), producing a new buffer; here
    the row is written into the caller's buffer, so a cache passed to a
    decode step is consumed by it. A row whose length has run past the
    buffer (an idle serving slot) is left untouched, as the one-hot select
    would leave it: its write lands on the last row with that row's own
    value. A :class:`KVBlock` takes the rows that fall in it.
    """
    B, S = cache.k.shape[:2]
    b = torch.arange(B, device=cache.k.device)
    if cache.start:  # a block of the sequence: rows before it are not its
        row = cache.length.long() - cache.start
        fits = ((row >= 0) & (row < S))[:, None, None]
        row = torch.clamp(row, 0, S - 1)
    else:
        row = torch.clamp(cache.length.long(), max=S - 1)
        fits = (cache.length < S)[:, None, None]
    cache.k[b, row] = torch.where(fits, k_new[:, 0].to(cache.k.dtype),
                                  cache.k[b, row])
    cache.v[b, row] = torch.where(fits, v_new[:, 0].to(cache.v.dtype),
                                  cache.v[b, row])


def decode_attend(params: dict, cfg, x: torch.Tensor, cache: KVCache,
                  window: int = 0, tp=UNSPLIT):
    """One new token per sequence against the cache.

    x: (B, 1, D). Returns (out (B, 1, D), new_cache); the K/V rows are
    appended in place (see :func:`append_kv`). ``tp``: see the module
    docstring.
    """
    B = x.shape[0]
    idx = cache.length
    q, k_new, v_new, local, kv_local = _split_qkv(params, cfg, x,
                                                  idx[:, None], tp)
    if kv_local:
        k_new, v_new = tp.gather(k_new, -2), tp.gather(v_new, -2)
    append_kv(cache, k_new, v_new)
    k, v = cache.whole()
    k = _core_kv(tp, cfg, k, local, False)
    v = _core_kv(tp, cfg, v, local, False)

    hkv = k.shape[2]
    heads = q.shape[2]
    rep = heads // hkv
    hd = cfg.head_dim_
    qg = q[:, 0].reshape(B, hkv, rep, hd)
    # bf16 operands, f32 products and sums
    scores = torch.einsum("bgrk,bsgk->bgrs", qg.to(k.dtype).float(),
                          k.float())
    scores = scores / torch.sqrt(
        torch.full((), hd, dtype=torch.float32, device=x.device))
    spos = torch.arange(k.shape[1], device=x.device)[None, None, None, :]
    valid = spos <= idx[:, None, None, None]
    if window:
        valid &= spos > (idx[:, None, None, None] - window)
    scores = torch.where(valid, scores, NEG_INF)
    m = torch.amax(scores, dim=-1, keepdim=True)
    e = torch.where(valid, torch.exp(scores - m), 0.0)
    num = torch.einsum("bgrs,bsgk->bgrk", e.to(v.dtype).float(), v.float())
    den = torch.sum(e, dim=-1)[..., None]
    out = (num / torch.clamp_min(den, 1e-30)).to(x.dtype)
    out = out_project(out.reshape(B, 1, heads, hd), params["wo"], tp,
                      local)
    return out, KVCache(k=cache.k, v=cache.v, length=cache.length + 1)
