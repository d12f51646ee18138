"""Plain reference of the RWKV6 (Finch) decoder as the program states it:
RMSNorm, time mixing with a static token-shift mix, a data-dependent
decay ``w = exp(-exp(x W_decay + bias))`` and the per-head WKV
recurrence, then squared-ReLU channel mixing.

Teacher-forced over each sequence (prompt, then every served token but
the last): the program's prefill over the prompt and its decode steps
over the tokens run the same recurrence from a zero state, so one pass
over the whole sequence is the reference of both. Its logits at the
positions that produced each served token go to ``on_logits``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench import weights
from portbench.reference.llama import _mm, _rms


def _shift(x):
    """(B, T, D) -> the previous token's rows, zero before the first."""
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def _wkv(r, k, v, w, u):
    """The recurrence over T: r, k, v, w (B, T, h, hd), u (h, hd); the
    state (B, h, hd_k, hd_v) from zero. Returns (B, T, h, hd)."""
    B, T, h, hd = r.shape
    state = torch.zeros((B, h, hd, hd), device=r.device)
    out = torch.empty_like(r)
    ub = u[None, :, :, None]
    for t in range(T):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        out[:, t] = torch.einsum("bhk,bhkv->bhv", r[:, t], state + ub * kv)
        state = w[:, t, :, :, None] * state + kv
    return out


def forward(params, s: dict, seqs: list, seq_len: int, prec, on_logits,
            chunk: int = 256) -> dict:
    """As ``llama.forward``; ``seq_len``, ``sectored`` and ``tables`` do
    not apply, and there is no table to compare."""
    dev = params["embedding"].device
    B = len(seqs)
    lens = [len(q["tokens"]) for q in seqs]
    T = max(lens)
    tok = np.zeros((B, T), np.int64)
    for b, q in enumerate(seqs):
        tok[b, :lens[b]] = q["tokens"]
    x = params["embedding"][torch.as_tensor(tok, device=dev)].float()
    h_, hd, eps = s["heads"], s["head_dim"], s["eps"]
    for i in range(s["layers"]):
        lp = weights.layer(params, i)
        tm = lp["tmix"]
        mix = tm["mix"].to(params["embedding"].dtype).float()
        h = _rms(x, lp["norm1"], eps)
        hs = _shift(h)
        proj = [_mm(prec, h * mix[j] + hs * (1 - mix[j]), tm[name])
                for j, name in enumerate(("wr", "wk", "wv", "wg",
                                          "w_decay"))]
        r, k, v, g, dec = proj
        w = torch.exp(-torch.exp(dec + tm["decay_bias"].float()))
        o = _wkv(*(t.reshape(B, T, h_, hd) for t in (r, k, v, w)),
                 tm["u"].float())
        x = x + _mm(prec, o.reshape(B, T, -1) * F.silu(g), tm["wo"])
        h = _rms(x, lp["norm2"], eps)
        xk = h * mix[1] + _shift(h) * (1 - mix[1])
        x = x + _mm(prec, torch.square(F.relu(_mm(prec, xk, tm["ck"]))),
                    tm["cv"])
    hidden = _rms(x, params["final_norm"], eps)
    head = params["embedding"] if s["tied"] else params["lm_head"]
    for b, q in enumerate(seqs):
        for p0 in range(q["prompt_len"] - 1, lens[b], chunk):
            p1 = min(p0 + chunk, lens[b])
            on_logits(b, p0, _mm(prec, hidden[b, p0:p1], head.t()))
    return {}
