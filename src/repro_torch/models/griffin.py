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

With ``tp`` (a ``parallel.tensor.TP``; the default ``tensor.UNSPLIT``
runs every product whole) the parameters are the rank's blocks: where ``w_x``, ``w_gate_r`` and ``w_gate_i`` split their
columns, the gates and the recurrence run on the rank's channels and
``w_out``'s split rows contract them, summed over 'model'; any other
landing makes the gates whole first. The returned state is whole.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.parallel.tensor import UNSPLIT

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


def _decay(log_a: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Per-step decay a_t in (0, 1): a = exp(softplus(log_a) * -8 * r)."""
    c = F.softplus(log_a)
    return torch.exp(A_MAX_LOG * c * r)


def _gates(params: dict, xf: torch.Tensor, tp=UNSPLIT):
    """``(a, b, local)`` of the recurrence h = a h + b for f32 inputs
    ``xf``: ``local`` where they are the rank's channels (else whole)."""
    names = ("w_gate_r", "w_gate_i", "w_x")
    lands = [tp.land(n) for n in names]
    xc = tp.copy_for(xf, *lands)
    outs = [tp.linear(xf, params[n].float(), land, copied=xc)
            for n, land in zip(names, lands)]
    dims = {d for _, d in outs}
    local = len(dims) == 1 and None not in dims
    r, i, xi = (y if local else tp.full(y, d) for y, d in outs)
    r, i = torch.sigmoid(r), torch.sigmoid(i)
    log_a = params["log_a"]
    a = _decay(tp.scatter(log_a, 0) if local else log_a, r)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.square(a), 1e-9)) * (i * xi)
    return a, b, local


def scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor):
    """h_t = a_t h_{t-1} + b_t, token by token: a, b (B, S, D), h0 (B,
    D). Returns (every h_t (B, S, D), the last)."""
    h = h0
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1), h


def _split_out(params: dict, hh: torch.Tensor, tp, local: bool):
    """``w_out``'s product of the states ``hh``, whole on every rank."""
    y, yd = tp.linear(hh, params["w_out"].float(), tp.land("w_out"),
                      x_dim=0 if local else None)
    return tp.full(y, yd)


def rglru(params: dict, x: torch.Tensor, h0: torch.Tensor, tp=UNSPLIT):
    """x: (B, S, D); h0: (B, D) f32. Returns (y (B, S, D), h_last)."""
    a, b, local = _gates(params, x.float(), tp)
    hh, h = scan(a, b, tp.scatter(h0, -1) if local else h0)
    y = _split_out(params, hh, tp, local)
    return y.to(x.dtype), tp.full(h, h.ndim - 1 if local else None)


def rglru_step(params: dict, x: torch.Tensor, h: torch.Tensor, tp=UNSPLIT):
    """Decode step: x (B, 1, D), h (B, D) -> (y (B, 1, D), h')."""
    a, b, local = _gates(params, x[:, 0].float(), tp)
    h_new = a * (tp.scatter(h, -1) if local else h) + b
    y = _split_out(params, h_new, tp, local)
    return (y[:, None, :].to(x.dtype),
            tp.full(h_new, h_new.ndim - 1 if local else None))


def init_rec_state(cfg, batch: int, device=None) -> torch.Tensor:
    return torch.zeros((batch, cfg.d_model), dtype=torch.float32,
                       device=device)
