"""Sector Predictor for the KV-cache runtime (counterpart of the JAX
package's ``runtime/sector_predictor.py``): the paper's SHT adapted to
serving.

The table is a per-(batch, kv-head, page) EMA of observed attention mass,
and prediction is top-K selection over it.

Tie-breaking: the reference selects with ``lax.top_k``, which breaks ties
toward the LOWER index. Ties are common — every invalid page scores
``-inf`` whenever k exceeds the valid pages, and a fresh table is all
zeros. ``torch.topk`` gives no such guarantee (on the CPU it returned
``[49, 32, 36, ...]`` where JAX returned ``[49, 0, 1, ...]``), so
:func:`predict_topk` takes a *stable* descending sort and keeps its first
k entries.
"""

from __future__ import annotations

import numpy as np
import torch

EMA_DECAY = 0.85  # history weight
RECENCY_BONUS = 1e3  # the page being written is always fetched
PROBE_BONUS = 2.0  # probe page outranks any history score (EMA mass <= 1)
#                    but never the recency page


def init_table(n_layers: int, batch: int, kv_heads: int, n_pages: int,
               device=None) -> torch.Tensor:
    """Sector-history table: EMA attention mass per page."""
    return torch.zeros((n_layers, batch, kv_heads, n_pages),
                       dtype=torch.float32, device=device)


def probe_page_for(position: torch.Tensor, page_size: int) -> torch.Tensor:
    """Deterministic round-robin probe page for a decode position: walks
    ``0 .. n_valid-1`` as the position advances. A pure function of the
    position, so probing preserves every stream-identity oracle."""
    n_valid = position // page_size + 1
    return position % n_valid


def predict_topk(table_l: torch.Tensor, position: torch.Tensor,
                 page_size: int, k: int, probe_page=None) -> torch.Tensor:
    """Select the top-k sectors for each (batch, kv-head).

    table_l: (B, Hkv, P) scores for one layer; position (B,). Returns
    (B, Hkv, k) int32 page indices in ascending page order. The page being
    written gets :data:`RECENCY_BONUS`; ``probe_page`` ((B,), optional)
    gets :data:`PROBE_BONUS`; pages past the current fill score ``-inf``.
    Ties break toward the lower page index, as ``lax.top_k`` does.
    """
    B, H, P = table_l.shape
    pages = torch.arange(P, device=table_l.device)
    cur_page = (position // page_size).long()
    recency = (pages[None, :] >= cur_page[:, None]).float()
    scores = table_l + RECENCY_BONUS * recency[:, None, :]
    if probe_page is not None:
        probed = (pages[None, :] == probe_page.long()[:, None]).float()
        scores = scores + PROBE_BONUS * probed[:, None, :]
    valid = pages[None, :] <= cur_page[:, None]
    scores = torch.where(valid[:, None, :], scores, -torch.inf)
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    return torch.sort(order[..., :k], dim=-1).values.to(torch.int32)


def pool_demands(table: torch.Tensor, group_ids) -> torch.Tensor:
    """OR-merge sector demands across a leading slot axis.

    table: (S, ...) non-negative scores; group_ids (S,) ints in [0, S) —
    slots sharing an id read the same KV pages (shared prompt prefix).
    Each slot's scores become the element-wise max over its group, so
    every member predicts the same sector set. Ids outside ``[0, S)``
    raise: the reference's segment_max would drop them and its gather
    clamp them — silent demand corruption.
    """
    n_slots = table.shape[0]
    ids = np.asarray(group_ids)
    if ids.size:
        lo, hi = int(ids.min()), int(ids.max())
        if lo < 0 or hi >= n_slots:
            raise ValueError(f"group_ids must lie in [0, {n_slots}); "
                             f"got range [{lo}, {hi}]")
    gids = torch.as_tensor(ids, dtype=torch.long, device=table.device)
    index = gids.reshape((-1,) + (1,) * (table.dim() - 1)).expand_as(table)
    pooled = torch.full_like(table, -torch.inf).scatter_reduce(
        0, index, table, reduce="amax", include_self=True)
    return torch.clamp_min(pooled[gids], 0.0)


def update(table_l: torch.Tensor, page_idx: torch.Tensor,
           page_mass: torch.Tensor) -> torch.Tensor:
    """Fold observed per-page attention mass back into the table.

    page_idx: (B, Hkv, k) pages that were fetched; page_mass (B, Hkv, k)
    the attention mass observed on each.
    """
    decayed = table_l * EMA_DECAY
    upd = torch.zeros_like(table_l).scatter_add_(-1, page_idx.long(),
                                                 page_mass)
    return decayed + (1.0 - EMA_DECAY) * upd
