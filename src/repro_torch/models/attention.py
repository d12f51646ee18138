"""Grouped-query attention for decode (counterpart of the JAX package's
``models/attention.py``: ``qkv``, ``KVCache``, ``init_cache`` and
``decode_attend``). Full-sequence ``attend`` and its blocked form belong
to a later slice of the port (prefill and training).

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
