"""Plain reference of a llama-style decoder (yi-6b) served on the sectored
path: RMSNorm, grouped-query attention with split-half RoPE, SwiGLU.

Teacher-forced over each sequence (prompt, then every served token but
the last), layer by layer, every position at once. A position's
attention reads the KV pages its serving step reads: every valid page
for the exact step (the prompt's scan, or a wave the policy runs exact)
and wherever the valid pages fit the sectored budget; otherwise the
pages that the frozen predictor (``predictor.select``) picks from the
program's sector-history table as its wave found it.

Following the program's table, and not this reference's own, is the one
place where the reference follows the program step by step: a page
choice is a top-k over table entries that agree between the program and
any independent computation only to rounding, and a choice that flips
on a near tie stays flipped (the pages read keep their scores), so two
sound computations part for good within a few hundred tokens of a long
context. The table itself is checked apart: the reference keeps its own,
from its own attention masses, and reports the widest gap between the
two (``table_gap``). Logits at the positions that produced each served
token go to ``on_logits``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench import weights
from portbench.reference import predictor


def _rms(x, w, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * w.float()


def _rope(x, cos, sin):
    """Split-half rotation of (B, T, heads, hd) by (T, hd/2) angles."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    c, s = cos[None, :, None], sin[None, :, None]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _mm(prec, x, w):
    """``x @ w`` over x's last dim and w's first (w (in, ...))."""
    w2 = prec.weight(w.reshape(w.shape[0], -1))
    return (prec.act(x) @ w2).reshape(*x.shape[:-1], *w.shape[1:])


def forward(params, s: dict, seqs: list, seq_len: int, prec, on_logits,
            chunk: int = 256) -> dict:
    """``seqs``: dicts with ``tokens`` (T,) int, ``prompt_len`` P,
    ``sectored`` (T,) bool (the step at each position ran sectored) and
    ``tables`` (T, L, G, pages) float32, the program's table after each
    position (NaN where it was not seen). ``on_logits(i, p0, logits)``
    gets float32 logits of sequence ``i``'s positions ``p0 ..`` from
    ``P - 1`` on, in chunks. Returns ``{"table_gap": g}``."""
    dev = params["embedding"].device
    B = len(seqs)
    lens = [len(q["tokens"]) for q in seqs]
    T = max(lens)
    k_sel, probe_on, pages = predictor.budget(seq_len)
    if T > pages * predictor.PAGE:
        raise ValueError(f"{T} tokens exceed the {pages}-page state")
    tok = np.zeros((B, T), np.int64)
    sect = np.zeros((B, T), bool)
    live = np.zeros((B, T), bool)
    for b, q in enumerate(seqs):
        tok[b, :lens[b]] = q["tokens"]
        sect[b, :lens[b]] = q["sectored"]
        live[b, :lens[b]] = True
    x = params["embedding"][torch.as_tensor(tok, device=dev)].float()
    hd, eps, L = s["head_dim"], s["eps"], s["layers"]
    inv = 1.0 / (s["rope_theta"] ** (torch.arange(
        0, hd, 2, dtype=torch.float64, device=dev) / hd))
    ang = torch.arange(T, dtype=torch.float64, device=dev)[:, None] * inv
    cos, sin = torch.cos(ang).float(), torch.sin(ang).float()
    tables = torch.full((B, T, L, s["kv_heads"], pages), float("nan"),
                        device=dev)
    for b, q in enumerate(seqs):
        if "tables" in q:
            tables[b, :lens[b]] = torch.as_tensor(q["tables"], device=dev)
    narrow = k_sel + probe_on
    table_gap = 0.0
    for i in range(L):
        lp = weights.layer(params, i)
        h = _rms(x, lp["norm1"], eps)
        q = _rope(_mm(prec, h, lp["attn"]["wq"]), cos, sin)
        k = _rope(_mm(prec, h, lp["attn"]["wk"]), cos, sin)
        v = _mm(prec, h, lp["attn"]["wv"])
        sel, kept = _pages(tables[:, :, i], sect, live, narrow, probe_on)
        att, mass = _attend(q, k, v, sel, kept, pages, prec, chunk)
        table_gap = max(table_gap, _table_gap(sel, kept, mass,
                                              tables[:, :, i], pages))
        wo = lp["attn"]["wo"]
        x = x + _mm(prec, att.flatten(2), wo.reshape(-1, wo.shape[-1]))
        h = _rms(x, lp["norm2"], eps)
        mlp = lp["mlp"]
        x = x + _mm(prec, F.silu(_mm(prec, h, mlp["w_gate"]))
                    * _mm(prec, h, mlp["w_up"]), mlp["w_down"])
        del q, k, v, att, h, sel, kept, mass
    hidden = _rms(x, params["final_norm"], eps)
    head = params["embedding"] if s["tied"] else params["lm_head"]
    for b, q in enumerate(seqs):
        for p0 in range(q["prompt_len"] - 1, lens[b], chunk):
            p1 = min(p0 + chunk, lens[b])
            on_logits(b, p0, _mm(prec, hidden[b, p0:p1], head.t()))
    return dict(table_gap=table_gap)


def _pages(prog: torch.Tensor, sect, live, narrow: int, probe_on: int):
    """Pages each position reads, ``(sel, kept)`` (B, T, G, W): every
    valid page where the step is exact or they fit ``narrow``; else the
    predictor's pick from the program's table after the position
    before. ``prog`` (B, T, G, pages)."""
    B, T, G, P = prog.shape
    dev = prog.device
    t = torch.arange(T, device=dev)
    n_valid = t // predictor.PAGE + 1
    pick = torch.as_tensor(sect & live, device=dev) & (n_valid > narrow)
    exact_need = torch.as_tensor(live & ~sect, device=dev) | (
        n_valid <= narrow)
    W = max(narrow, int(torch.max(torch.where(
        exact_need.any(0), n_valid, 0))))
    W = min(W, P)
    ar = torch.arange(W, device=dev)
    sel = ar.expand(B, T, G, W).clone()
    kept = (ar < n_valid[:, None])[None, :, None].expand(B, T, G, W).clone()
    if bool(pick.any()):
        bt = pick.nonzero(as_tuple=True)
        before = prog[bt[0], bt[1] - 1]  # (n, G, P)
        if bool(torch.isnan(before).any()):
            raise ValueError("a sectored step past the budget without the "
                             "program's table before it")
        n = before.shape[0]
        s_, k_ = predictor.select(
            before, bt[1], torch.full((n,), narrow, device=dev),
            torch.full((n,), bool(probe_on), device=dev), W)
        sel[bt], kept[bt] = s_, k_
    return sel, kept


def _attend(q, k, v, sel, kept, pages: int, prec, chunk: int):
    """Attention of every position over its pages, and each page's mass
    (the program's: each query row's weights against its own max, summed
    over the kv head's rows). q (B, T, H, hd), k / v (B, T, G, hd) ->
    (out (B, T, H, hd), mass (B, T, G, W))."""
    B, T, H, hd = q.shape
    G = k.shape[2]
    W = sel.shape[-1]
    dev = q.device
    page = predictor.PAGE

    def paged(t):
        buf = torch.zeros((B, pages * page, G, hd), device=dev)
        buf[:, :T] = t
        return buf.view(B, pages, page, G, hd).permute(
            0, 3, 1, 2, 4).contiguous()

    kp, vp = paged(k), paged(v)
    qg = q.reshape(B, T, G, H // G, hd)
    out = torch.empty((B, T, G, H // G, hd), device=dev)
    mass = torch.empty((B, T, G, W), device=dev)
    bi = torch.arange(B, device=dev)[:, None, None, None]
    gi = torch.arange(G, device=dev)[None, None, :, None]
    offs = torch.arange(page, device=dev)
    scale = math.sqrt(hd)
    for t0 in range(0, T, chunk):
        t1 = min(t0 + chunk, T)
        s_ = sel[:, t0:t1]
        ks, vs = kp[bi, gi, s_], vp[bi, gi, s_]  # (B, C, G, W, page, hd)
        pos = torch.arange(t0, t1, device=dev)[None, :, None, None, None]
        valid = ((s_[..., None] * page + offs) <= pos) & kept[:, t0:t1,
                                                             ..., None]
        sc = torch.einsum("btgrk,btgcpk->btgrcp", prec.act(qg[:, t0:t1]),
                          prec.act(ks)) / scale
        vm = valid[:, :, :, None]
        sc = torch.where(vm, sc, predictor.NEG)
        e = torch.where(vm, torch.exp(sc - torch.amax(
            sc, dim=(-2, -1), keepdim=True)), 0.0)
        num = torch.einsum("btgrcp,btgcpk->btgrk", prec.act(e, (-2, -1)),
                           prec.act(vs, (3, 4)))
        out[:, t0:t1] = num / e.sum(dim=(-2, -1))[..., None]
        mass[:, t0:t1] = e.sum(dim=(3, 5)) / e.sum(dim=(3, 4, 5))[..., None]
    return out.reshape(B, T, H, hd), mass


def _table_gap(sel, kept, mass, prog, pages: int, block: int = 64) -> float:
    """This reference's sector-history table after every position (the
    EMA of its own masses from a zero table), against the program's
    where it was seen: the widest gap."""
    B, T, G, W = sel.shape
    dev = sel.device
    upd = torch.zeros((B, T, G, pages), device=dev).scatter_add_(
        -1, sel, torch.where(kept, mass, 0.0)) * (1.0 - predictor.EMA_DECAY)
    j = torch.arange(block, device=dev, dtype=torch.float64)
    decay = torch.where(j[:, None] >= j[None, :], predictor.EMA_DECAY ** (
        j[:, None] - j[None, :]), 0.0).float()  # (block, block)
    carry_w = (predictor.EMA_DECAY ** (j + 1)).float()
    table = torch.zeros((B, G, pages), device=dev)
    widest = 0.0
    for t0 in range(0, T, block):
        t1 = min(t0 + block, T)
        n = t1 - t0
        ref = (torch.einsum("ji,bigp->bjgp", decay[:n, :n], upd[:, t0:t1])
               + carry_w[None, :n, None, None] * table[:, None])
        table = ref[:, -1]
        seen = prog[:, t0:t1]
        gap = torch.where(torch.isnan(seen), 0.0, (ref - seen).abs())
        widest = max(widest, float(gap.max()))
    return widest
