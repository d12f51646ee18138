"""Shared neural building blocks (counterpart of the JAX package's
``models/layers.py``).

Parameters are plain dicts of tensors; every function takes
``(params, inputs)`` and returns outputs. Numerics follow the reference:
bf16 projections stay bf16 products (``torch.matmul`` accumulates in f32
and rounds once, like XLA's bf16 dot), and every ``astype`` of the
reference is a cast at the same place here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5):
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def init_rms(d: int, dtype, device) -> torch.Tensor:
    return torch.ones((d,), dtype=dtype, device=device)


# --- rotary position embeddings ----------------------------------------------

def _rope_angles(positions: torch.Tensor, dim: int, base: float = 10000.0):
    """positions (...,) -> cos/sin of shape (..., dim//2), f32."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    inv = 1.0 / torch.pow(torch.full((), base, dtype=torch.float32,
                                     device=positions.device), exps)
    ang = positions[..., None].float() * inv
    return torch.cos(ang), torch.sin(ang)


def _apply_rot(x: torch.Tensor, cos, sin) -> torch.Tensor:
    """Rotate the two halves of the last dim (split-half rotation, as the
    reference's ``_apply_rot``); cos/sin broadcast over heads. f32 out."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               kind: str = "standard", base: float = 10000.0):
    """x: (B, S, H, hd); positions: (B, S) int.

    kind:
      standard — full-dim rotation (llama-family).
      rope2d   — ChatGLM 2-D RoPE: rotate only the first half of head_dim.
      mrope    — Qwen2-VL M-RoPE: head_dim split into 3 sections rotated by
                 (temporal, height, width) streams; text-only, so all three
                 streams equal ``positions``.
    """
    hd = x.shape[-1]
    if kind == "none":
        return x
    if kind == "standard":
        cos, sin = _rope_angles(positions, hd, base)
        return _apply_rot(x, cos[..., None, :], sin[..., None, :]).to(x.dtype)
    if kind == "rope2d":
        half = hd // 2
        cos, sin = _rope_angles(positions, half, base)
        xr = _apply_rot(x[..., :half], cos[..., None, :], sin[..., None, :])
        return torch.cat([xr.to(x.dtype), x[..., half:]], dim=-1)
    if kind == "mrope":
        s1 = hd // 2
        s2 = hd // 4
        s3 = hd - s1 - s2
        outs = []
        off = 0
        for sec in (s1, s2, s3):
            cos, sin = _rope_angles(positions, sec, base)
            outs.append(_apply_rot(x[..., off:off + sec],
                                   cos[..., None, :], sin[..., None, :]))
            off += sec
        return torch.cat(outs, dim=-1).to(x.dtype)
    raise ValueError(kind)


# --- MLPs ---------------------------------------------------------------------

def swiglu(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Gated MLP: silu(x @ w_gate) * (x @ w_up) @ w_down."""
    g = torch.matmul(x, params["w_gate"])
    u = torch.matmul(x, params["w_up"])
    h = F.silu(g.float()).to(x.dtype) * u
    return torch.matmul(h, params["w_down"])


def _normal(gen, shape, dtype, device, scale: float) -> torch.Tensor:
    """N(0, 1) drawn in ``dtype`` and scaled in it (as the reference's
    ``jax.random.normal(key, shape, dtype) * s``)."""
    return torch.randn(shape, generator=gen, dtype=dtype, device=device) * scale


def init_swiglu(gen, d: int, f: int, dtype, device, lead=()) -> dict:
    s = d ** -0.5
    return dict(
        w_gate=_normal(gen, (*lead, d, f), dtype, device, s),
        w_up=_normal(gen, (*lead, d, f), dtype, device, s),
        w_down=_normal(gen, (*lead, f, d), dtype, device, f ** -0.5),
    )


def embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["embedding"][tokens.long()]


def unembed(params: dict, x: torch.Tensor, tied: bool) -> torch.Tensor:
    w = params["embedding"] if tied else params["lm_head"]
    return torch.matmul(x, w.t())


def init_embed(gen, vocab: int, d: int, dtype, device, tied: bool) -> dict:
    p = dict(embedding=_normal(gen, (vocab, d), dtype, device, 0.02))
    if not tied:
        p["lm_head"] = _normal(gen, (vocab, d), dtype, device, 0.02)
    return p
