"""RG-LRU recurrent block (counterpart of the JAX package's
``models/griffin.py``, RecurrentGemma / Griffin).

The Real-Gated Linear Recurrent Unit:
    r_t = sigmoid(W_r x_t);  i_t = sigmoid(W_i x_t)
    a_t = a_max ** (c * r_t)            (per-channel learned decay base)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
all in f32. The reference runs the prompt's recurrence as a log-depth
``associative_scan``; here it is a loop over the sequence, which forms
the products in another order, so the two agree within a tolerance, not
bitwise. Decode is one fused update (:func:`rglru_step`). Plain torch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers

A_MAX_LOG = -8.0  # log of minimum decay => a in (exp(-8), 1)


def init_rec(gen, cfg, dtype, device, lead=()) -> dict:
    d = cfg.d_model
    s = d ** -0.5
    n = layers._normal
    return dict(
        w_x=n(gen, (*lead, d, d), dtype, device, s),
        w_gate_r=n(gen, (*lead, d, d), dtype, device, s),
        w_gate_i=n(gen, (*lead, d, d), dtype, device, s),
        w_out=n(gen, (*lead, d, d), dtype, device, s),
        log_a=torch.full((*lead, d), -0.7, dtype=torch.float32,
                         device=device),
    )


def _decay(params: dict, r: torch.Tensor) -> torch.Tensor:
    """Per-step decay a_t in (0, 1): a = exp(softplus(log_a) * -8 * r)."""
    c = F.softplus(params["log_a"])
    return torch.exp(A_MAX_LOG * c * r)


def _gates(params: dict, xf: torch.Tensor):
    """(a, b) of the recurrence h = a h + b for f32 inputs ``xf``."""
    r = torch.sigmoid(torch.matmul(xf, params["w_gate_r"].float()))
    i = torch.sigmoid(torch.matmul(xf, params["w_gate_i"].float()))
    xi = torch.matmul(xf, params["w_x"].float())
    a = _decay(params, r)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.square(a), 1e-9)) * (i * xi)
    return a, b


def rglru(params: dict, x: torch.Tensor, h0: torch.Tensor):
    """x: (B, S, D); h0: (B, D) f32. Returns (y (B, S, D), h_last)."""
    a, b = _gates(params, x.float())
    h = h0
    hs = []
    for t in range(x.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    hh = torch.stack(hs, dim=1)
    y = torch.matmul(hh, params["w_out"].float())
    return y.to(x.dtype), h


def rglru_step(params: dict, x: torch.Tensor, h: torch.Tensor):
    """Decode step: x (B, 1, D), h (B, D) -> (y (B, 1, D), h')."""
    a, b = _gates(params, x[:, 0].float())
    h_new = a * h + b
    y = torch.matmul(h_new, params["w_out"].float())
    return y[:, None, :].to(x.dtype), h_new


def init_rec_state(cfg, batch: int, device=None) -> torch.Tensor:
    return torch.zeros((batch, cfg.d_model), dtype=torch.float32,
                       device=device)
