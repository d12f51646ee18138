"""Mixture-of-Experts layer (counterpart of the JAX package's
``models/moe.py``): top-k routing, sort-based grouped dispatch, capacity
drops, batched expert products and a weighted combine.

Plain torch throughout, as the reference leaves MoE to XLA: the expert
products are ``torch.bmm`` over the stacked ``(E, ...)`` expert weights,
so every expert's weights are read whatever the routing (the reference's
formulation; a gather of the routed experts only is a later speed step).

Port notes:

* the argsort by expert is stable (``jnp.argsort``'s default), so the
  assignments of one expert keep token order and capacity drops the
  same ones;
* the capacity ``cap`` is a Python int from shapes: no value leaves the
  device, so a wave over this layer can be captured as a CUDA graph;
* the combine is deterministic: the reference's scatter-add of each
  token's k contributions (``.at[sorted_token].add``, bf16) adds them one
  at a time in sorted (expert-ascending) order, as XLA's sequential
  scatter does; ``index_add_`` on the card would add them with atomics in
  an order that changes from run to run. Here each token's k
  contributions are gathered through the inverse permutation into
  ``(T, k, D)`` and added into a bf16 zero row in that order.
* ``torch.topk`` on the card does not promise the lower index on an
  exact tie in the router logits, as ``jax.lax.top_k`` does.

With ``tp`` (a ``parallel.tensor.TP``; the default ``tensor.UNSPLIT``
runs every product whole) and the experts split over 'model', the rank
computes its block of the router's columns and the logits are
gathered whole (exact), so every rank routes, drops and dispatches the
same; ``capacity`` stays on the global token count. The rank runs its
``E / m`` experts on their rows of the grouped buffer, the expert
outputs are gathered over 'model' and combined as above: every step
that crosses ranks moves data only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.parallel.tensor import UNSPLIT

CAPACITY_FACTOR = 1.25


def init_moe(gen, cfg, dtype, device, lead=()) -> dict:
    """Router (f32), stacked expert weights ``(*lead, E, D, F)`` /
    ``(*lead, E, F, D)`` and, with ``n_shared_experts``, the shared
    expert's SwiGLU."""
    d, e = cfg.d_model, cfg.moe
    s = d ** -0.5
    n = layers._normal
    p = dict(
        router=n(gen, (*lead, d, e.n_experts), torch.float32, device, s),
        w_gate=n(gen, (*lead, e.n_experts, d, e.d_expert), dtype, device, s),
        w_up=n(gen, (*lead, e.n_experts, d, e.d_expert), dtype, device, s),
        w_down=n(gen, (*lead, e.n_experts, e.d_expert, d), dtype, device,
                 e.d_expert ** -0.5),
    )
    if e.n_shared_experts:
        p["shared"] = layers.init_swiglu(
            gen, d, e.d_expert * e.n_shared_experts, dtype, device,
            lead=lead)
    return p


def capacity(n_tokens: int, cfg) -> int:
    """Assignments an expert keeps in a call over ``n_tokens`` tokens."""
    e = cfg.moe
    return int(n_tokens * e.top_k * CAPACITY_FACTOR / e.n_experts) + 1


def route(params: dict, cfg, xt: torch.Tensor, tp=UNSPLIT):
    """Router of ``xt`` (T, D): f32 logits (gathered whole where the
    router's columns are split), top-k, softmax over the k gates.
    Returns ``(gate (T, k) f32, idx (T, k) int64)``."""
    logits = tp.full(*tp.linear(xt.float(), params["router"],
                                tp.land("router")))
    gate, idx = torch.topk(logits, cfg.moe.top_k, dim=-1)
    return torch.softmax(gate, dim=-1), idx


def dispatch(idx: torch.Tensor, cfg):
    """The grouping of the reference: assignments (T*k, token-major)
    sorted stably by expert, each one's position in its expert's group
    and whether it fits the capacity. Returns ``(order, sorted_token,
    keep, slot, cap)``: ``order`` sorts the assignments, the rest are in
    sorted order; ``slot`` is the assignment's row of the grouped
    ``(E * cap + 1, D)`` buffer, the last row for a dropped one."""
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    T = idx.shape[0]
    flat_expert = idx.reshape(-1)
    flat_token = torch.repeat_interleave(
        torch.arange(T, device=idx.device), k)
    order = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order]
    sorted_token = flat_token[order]
    cap = capacity(T, cfg)
    seg_start = torch.searchsorted(
        sorted_expert, torch.arange(E, device=idx.device))
    pos_in_expert = (torch.arange(T * k, device=idx.device)
                     - seg_start[sorted_expert])
    keep = pos_in_expert < cap
    slot = torch.where(keep, sorted_expert * cap + pos_in_expert, E * cap)
    return order, sorted_token, keep, slot, cap


def _experts(params: dict, grouped: torch.Tensor, dtype, tp=UNSPLIT):
    """The batched expert FFN of ``grouped`` (E, cap, D); where 'model'
    splits the experts, the rank's experts on their rows, the outputs
    gathered over 'model'."""
    lands = [tp.land(n) for n in ("w_gate", "w_up", "w_down")]
    split = any(land.split for land in lands)
    if split and any((land.kind, land.dim) != ("output", 0)
                     for land in lands):
        raise NotImplementedError(
            f"expert tensors split as {lands}: the partitioned MoE splits "
            f"the experts only")
    if split:
        grouped = tp.scatter(grouped, 0)
    g = torch.bmm(grouped, params["w_gate"])
    u = torch.bmm(grouped, params["w_up"])
    h = F.silu(g.float()).to(dtype) * u
    y = torch.bmm(h, params["w_down"])
    return tp.gather(y, 0) if split else y


def moe_ffn(params: dict, cfg, x: torch.Tensor, tp=UNSPLIT) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D). ``tp``: see the module docstring."""
    e = cfg.moe
    B, S, D = x.shape
    T = B * S
    E, k = e.n_experts, e.top_k
    xt = x.reshape(T, D)

    gate, idx = route(params, cfg, xt, tp)
    order, sorted_token, keep, slot, cap = dispatch(idx, cfg)
    sorted_gate = gate.reshape(-1)[order]

    # tokens into (E * cap + 1 overflow, D); kept slots are distinct, the
    # dropped ones all land on the overflow row, which is cut off
    buf = torch.zeros((E * cap + 1, D), dtype=x.dtype, device=x.device)
    buf[slot] = xt[sorted_token]
    grouped = buf[:E * cap].reshape(E, cap, D)

    y = _experts(params, grouped, x.dtype, tp)

    # each kept assignment's expert output times its gate (bf16)
    y_flat = y.reshape(E * cap, D)
    contrib = torch.where(keep[:, None],
                          y_flat[torch.clamp(slot, max=E * cap - 1)],
                          0.0) * sorted_gate[:, None].to(x.dtype)
    # combine: each token's k contributions in sorted order, added one at
    # a time into a bf16 zero row (the reference's sequential scatter-add)
    inverse = torch.argsort(order)
    by_token = torch.sort(inverse.reshape(T, k), dim=1).values
    parts = contrib[by_token]  # (T, k, D)
    out = torch.zeros((T, D), dtype=x.dtype, device=x.device)
    for j in range(k):
        out = out + parts[:, j]

    if e.n_shared_experts:
        out = out + layers.swiglu(params["shared"], xt, tp.at("shared"))
    return out.reshape(B, S, D)
