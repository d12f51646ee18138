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

With ``tp`` (a ``parallel.tensor.TP``; the default ``tensor.UNSPLIT``
runs every product whole) the parameters are the rank's blocks: where
the heads divide over 'model', the receptance, key, value, gate and
decay reach the rank's block of channels (split columns stay local,
whole or summed ones are cut to the block) and the recurrence runs the
rank's heads; a split ``wo`` contracts them and sums over 'model', a
whole one reads them gathered. Channel-mix keeps ``ck``'s split columns
local for ``cv``'s split rows.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.parallel.tensor import UNSPLIT


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
             prev_x: torch.Tensor, tp=UNSPLIT, keep_state: bool = True):
    """x (B, S, D); state (B, H, hd, hd) f32; prev_x (B, D). Returns
    (out, state', last_x); without ``keep_state`` the state is None (a
    split group's heads' state is not gathered)."""
    B, S, D = x.shape
    hd = cfg.rwkv_head_dim
    xs = _token_shift(x, prev_x)
    mix = params["mix"].to(x.dtype)
    local = n_heads(cfg) % tp.size == 0
    want = 2 if local else None  # the channel dim of (B, S, D)
    out = []
    for i, name in enumerate(("wr", "wk", "wv", "wg", "w_decay")):
        y, yd = tp.linear(_mix(x, xs, mix[i]), params[name], tp.land(name))
        out.append(tp.reform(y, yd, want))
    r, k, v, g, dec = out
    hl = r.shape[-1] // hd
    r, k, v = (t.reshape(B, S, hl, hd).float() for t in (r, k, v))
    g = F.silu(g.float())
    # data-dependent decay in (0, 1): w = exp(-exp(d(x)))
    bias = tp.reform(params["decay_bias"], None, 0 if local else None)
    w = torch.exp(-torch.exp(dec.float() + bias)).reshape(B, S, hl, hd)
    u = tp.reform(params["u"], tp.land("u").dim, 0 if local else None)
    s0 = tp.scatter(state, 1) if local else state
    o, s_new = wkv_scan(r, k, v, w, u[None, :, :, None], s0)
    o = (o.reshape(B, S, hl * hd) * g).to(x.dtype)
    y, yd = tp.linear(o, params["wo"], tp.land("wo"),
                      x_dim=0 if local else None)
    if not keep_state:
        s_new = None
    elif local:
        s_new = tp.gather(s_new, 1)
    return tp.full(y, yd), s_new, x[:, -1, :]


def wkv_scan(r, k, v, w, u, state):
    """The WKV recurrence, token by token: r, k, v, w (B, S, h, hd), u
    (1, h, hd, 1), state (B, h, hd, hd), all f32. Returns (out (B, S, h,
    hd), the last state)."""
    outs = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]  # (B, h, hd, hd)
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t], state + u * kv))
        state = w[:, t, :, :, None] * state + kv
    return torch.stack(outs, dim=1), state


def channel_mix(params: dict, cfg, x: torch.Tensor, prev_x: torch.Tensor,
                tp=UNSPLIT):
    xs = _token_shift(x, prev_x)
    mix = params["mix"].to(x.dtype)
    xk = _mix(x, xs, mix[1])
    k, kd = tp.linear(xk, params["ck"], tp.land("ck"))
    k = torch.square(F.relu(k.float())).to(x.dtype)
    y, yd = tp.linear(k, params["cv"], tp.land("cv"),
                      x_dim=None if kd is None else 0)
    return tp.full(y, yd), x[:, -1, :]


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


def rwkv_block(params: dict, cfg, x: torch.Tensor, state: dict, tp=UNSPLIT,
               keep_state: bool = True):
    """Full RWKV6 block: time-mix + channel-mix with residuals.

    state: dict(S, prev_tmix, prev_cmix); returns (x', new state), the
    state's tensors new (the caller's are not written) and of its dtypes.
    Works for a prompt (S tokens) and for decode (S == 1). ``tp`` and
    ``keep_state``: see :func:`time_mix`.
    """
    mix_tp = tp.at("tmix")
    h = layers.rms_norm(x, params["norm1"], cfg.norm_eps)
    att, S_new, last_t = time_mix(params["tmix"], cfg, h, state["S"],
                                  state["prev_tmix"].to(x.dtype), mix_tp,
                                  keep_state)
    x = x + att
    h = layers.rms_norm(x, params["norm2"], cfg.norm_eps)
    ffn, last_c = channel_mix(params["tmix"], cfg, h,
                              state["prev_cmix"].to(x.dtype), mix_tp)
    x = x + ffn
    return x, dict(S=S_new, prev_tmix=last_t.to(state["prev_tmix"].dtype),
                   prev_cmix=last_c.to(state["prev_cmix"].dtype))
