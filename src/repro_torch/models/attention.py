"""Grouped-query attention (counterpart of the JAX package's
``models/attention.py``): ``qkv``, full causal ``attend`` (prefill) and its
blocked form, ``KVCache``, ``init_cache`` and one-token ``decode_attend``.
Everything here is plain torch, as the reference leaves it to XLA: no
kernel and no SDPA.

All shapes: x (B, S, D); q (B, S, H, hd); kv (B, S, Hkv, hd).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import layers

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


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one bf16 product."""
    d, h, k = w.shape
    return torch.matmul(x, w.reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


def qkv(params: dict, cfg, x: torch.Tensor, positions: torch.Tensor):
    q = _project(x, params["wq"])
    k = _project(x, params["wk"])
    v = _project(x, params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    if cfg.qk_norm:
        q = layers.rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = layers.rms_norm(k, params["k_norm"], cfg.norm_eps)
    q = layers.apply_rope(q, positions, cfg.rope)
    k = layers.apply_rope(k, positions, cfg.rope)
    return q, k, v


def out_project(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bqhk,hkd->bqd") as one bf16 product."""
    h, k, d = wo.shape
    return torch.matmul(out.reshape(*out.shape[:-2], h * k),
                        wo.reshape(h * k, d))


def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, Hkv, hd) -> (B, S, H, hd), each kv head repeated H/Hkv
    times."""
    return torch.repeat_interleave(k, n_heads // k.shape[2], dim=2)


def attend(params: dict, cfg, x: torch.Tensor, positions: torch.Tensor,
           window: int = 0) -> torch.Tensor:
    """Causal (optionally sliding-window) full attention: x (B, S, D),
    positions (B, S) -> (B, S, D).

    As the reference: bf16 scores (one bf16 product, then f32), an f32
    softmax cast to ``x.dtype`` before P·V. ``cfg.blocked_attention``
    (without a window) streams :func:`_attend_blocked` instead.
    """
    q, k, v = qkv(params, cfg, x, positions)
    if getattr(cfg, "blocked_attention", False) and window == 0:
        return out_project(_attend_blocked(cfg, q, k, v, positions),
                           params["wo"])
    kf = _expand_kv(k, cfg.n_heads)
    vf = _expand_kv(v, cfg.n_heads)
    # (B, H, S, hd) @ (B, H, hd, S): einsum("bqhk,bshk->bhqs")
    scores = torch.matmul(q.transpose(1, 2),
                          kf.permute(0, 2, 3, 1)).float()
    scores = scores / torch.sqrt(
        torch.full((), cfg.head_dim_, dtype=torch.float32, device=x.device))
    qpos = positions[:, :, None]
    kpos = positions[:, None, :]
    mask = kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    scores = torch.where(mask[:, None], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.matmul(w, vf.transpose(1, 2)).transpose(1, 2)
    return out_project(out, params["wo"])


def _attend_blocked(cfg, q, k, v, positions, block: int = 512):
    """Flash-style blocked causal attention in plain torch: KV blocks of
    ``block`` tokens streamed with a running max and sum, so no (S x S)
    score tensor exists. bf16 operands with f32 products and sums; ``p``
    is cast to the V dtype before P·V, as the reference does. Needs
    ``S % block == 0``, as the reference's reshape does.

    q (B, S, H, hd), k / v (B, S, Hkv, hd) -> (B, S, H, hd) in q's dtype.
    """
    B, S, H, hd = q.shape
    if S % block:
        raise ValueError(f"blocked attention needs S % {block} == 0, got "
                         f"S={S}")
    G = cfg.n_kv_heads
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
    value.
    """
    B, S = cache.k.shape[:2]
    b = torch.arange(B, device=cache.k.device)
    row = torch.clamp(cache.length.long(), max=S - 1)
    fits = (cache.length < S)[:, None, None]
    cache.k[b, row] = torch.where(fits, k_new[:, 0].to(cache.k.dtype),
                                  cache.k[b, row])
    cache.v[b, row] = torch.where(fits, v_new[:, 0].to(cache.v.dtype),
                                  cache.v[b, row])


def decode_attend(params: dict, cfg, x: torch.Tensor, cache: KVCache,
                  window: int = 0):
    """One new token per sequence against the cache.

    x: (B, 1, D). Returns (out (B, 1, D), new_cache); the K/V rows are
    appended in place (see :func:`append_kv`).
    """
    B = x.shape[0]
    idx = cache.length
    q, k_new, v_new = qkv(params, cfg, x, idx[:, None])
    append_kv(cache, k_new, v_new)
    k, v = cache.k, cache.v

    hkv = cfg.n_kv_heads
    rep = cfg.n_heads // hkv
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
    out = out_project(out.reshape(B, 1, cfg.n_heads, hd), params["wo"])
    return out, KVCache(k=k, v=v, length=cache.length + 1)
