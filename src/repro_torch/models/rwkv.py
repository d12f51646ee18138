"""RWKV6 ("Finch") block (counterpart of the JAX package's
``models/rwkv.py``): time-mix with data-dependent decay, then channel-mix.

State per head is a (head_dim x head_dim) outer-product accumulator:
    S_t = diag(w_t) @ S_{t-1} + k_t^T v_t
    o_t = (S_{t-1} + diag(u) k_t^T v_t) q_t      (receptance r_t acts as q)
with w_t = exp(-exp(decay(x_t))). The reference scans the time steps with
``lax.scan``; here they are a Python loop over the sequence (one
iteration in decode). ``S`` is f32, the token-shift carries
``prev_tmix`` / ``prev_cmix`` bf16, as in the reference. Plain torch: the
reference has no kernel here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers


def n_heads(cfg) -> int:
    return cfg.d_model // cfg.rwkv_head_dim


def init_rwkv(gen, cfg, dtype, device, lead=()) -> dict:
    d = cfg.d_model
    h, hd = n_heads(cfg), cfg.rwkv_head_dim
    s = d ** -0.5
    n = layers._normal
    f32 = dict(dtype=torch.float32, device=device)
    return dict(
        # time-mix projections (receptance, key, value, gate, output)
        wr=n(gen, (*lead, d, d), dtype, device, s),
        wk=n(gen, (*lead, d, d), dtype, device, s),
        wv=n(gen, (*lead, d, d), dtype, device, s),
        wg=n(gen, (*lead, d, d), dtype, device, s),
        wo=n(gen, (*lead, d, d), dtype, device, s),
        # data-dependent decay (low-rank) + per-channel boost u
        w_decay=n(gen, (*lead, d, d), dtype, device, s) * 0.1,
        decay_bias=torch.full((*lead, d), -2.0, **f32),
        u=torch.zeros((*lead, h, hd), **f32),
        # token-shift mix coefficients
        mix=torch.full((*lead, 5, d), 0.5, **f32),
        # channel-mix
        ck=n(gen, (*lead, d, cfg.d_ff), dtype, device, s),
        cv=n(gen, (*lead, cfg.d_ff, d), dtype, device, cfg.d_ff ** -0.5),
    )


def _token_shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """x: (B, S, D); prev: (B, D) last token of the previous chunk."""
    return torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)


def _mix(x, xs, coef):
    return x * coef + xs * (1 - coef)


def time_mix(params: dict, cfg, x: torch.Tensor, state: torch.Tensor,
             prev_x: torch.Tensor):
    """x (B, S, D); state (B, H, hd, hd) f32; prev_x (B, D). Returns
    (out, state', last_x)."""
    B, S, D = x.shape
    h, hd = n_heads(cfg), cfg.rwkv_head_dim
    xs = _token_shift(x, prev_x)
    mix = params["mix"].to(x.dtype)
    xr, xk, xv, xg, xw = (_mix(x, xs, mix[i]) for i in range(5))

    r = torch.matmul(xr, params["wr"]).reshape(B, S, h, hd).float()
    k = torch.matmul(xk, params["wk"]).reshape(B, S, h, hd).float()
    v = torch.matmul(xv, params["wv"]).reshape(B, S, h, hd).float()
    g = F.silu(torch.matmul(xg, params["wg"]).float())
    # data-dependent decay in (0, 1): w = exp(-exp(d(x)))
    dec = torch.matmul(xw, params["w_decay"]).float() + params["decay_bias"]
    w = torch.exp(-torch.exp(dec)).reshape(B, S, h, hd)
    u = params["u"][None, :, :, None]

    outs = []
    for t in range(S):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]  # (B, h, hd, hd)
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t], state + u * kv))
        state = w[:, t, :, :, None] * state + kv
    out = torch.stack(outs, dim=1).reshape(B, S, D)
    out = torch.matmul((out * g).to(x.dtype), params["wo"])
    return out, state, x[:, -1, :]


def channel_mix(params: dict, cfg, x: torch.Tensor, prev_x: torch.Tensor):
    xs = _token_shift(x, prev_x)
    mix = params["mix"].to(x.dtype)
    xk = _mix(x, xs, mix[1])
    k = torch.square(F.relu(torch.matmul(xk, params["ck"]).float()))
    return torch.matmul(k.to(x.dtype), params["cv"]), x[:, -1, :]


def init_state(cfg, batch: int, device=None,
               dtype=torch.bfloat16) -> dict:
    """``S`` in f32; the token-shift rows in ``dtype`` (bf16, as in the
    reference)."""
    h, hd = n_heads(cfg), cfg.rwkv_head_dim
    return dict(
        S=torch.zeros((batch, h, hd, hd), dtype=torch.float32, device=device),
        prev_tmix=torch.zeros((batch, cfg.d_model), dtype=dtype,
                              device=device),
        prev_cmix=torch.zeros((batch, cfg.d_model), dtype=dtype,
                              device=device),
    )


def rwkv_block(params: dict, cfg, x: torch.Tensor, state: dict):
    """Full RWKV6 block: time-mix + channel-mix with residuals.

    state: dict(S, prev_tmix, prev_cmix); returns (x', new state), the
    state's tensors new (the caller's are not written) and of its dtypes.
    Works for a prompt (S tokens) and for decode (S == 1).
    """
    h = layers.rms_norm(x, params["norm1"], cfg.norm_eps)
    att, S_new, last_t = time_mix(params["tmix"], cfg, h, state["S"],
                                  state["prev_tmix"].to(x.dtype))
    x = x + att
    h = layers.rms_norm(x, params["norm2"], cfg.norm_eps)
    ffn, last_c = channel_mix(params["tmix"], cfg, h,
                              state["prev_cmix"].to(x.dtype))
    x = x + ffn
    return x, dict(S=S_new, prev_tmix=last_t.to(state["prev_tmix"].dtype),
                   prev_cmix=last_c.to(state["prev_cmix"].dtype))
