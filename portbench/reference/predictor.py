"""Frozen copy of the serving path's sector arithmetic: page geometry,
page budget, and the sector-history table's selection and update (the
program's ``runtime/sectored_decode.py`` and
``runtime/sector_predictor.py`` as of this benchmark's first version).
The reference selects pages with it from its own table, so a later change
to the program's predictor is measured against this one.
"""

from __future__ import annotations

import torch

PAGE = 128  # tokens per KV sector
TOPK_FRAC = 1 / 8
MIN_TOPK = 4
EMA_DECAY = 0.85
RECENCY_BONUS = 1e3
PROBE_BONUS = 2.0
NEG = -1e30


def n_pages(seq_len: int) -> int:
    return (seq_len + PAGE - 1) // PAGE


def padded_pages(seq_len: int) -> int:
    """Pages of a state's KV buffer: a multiple of 8 with room for 8
    tokens past ``seq_len``."""
    return ((n_pages(seq_len + 8) + 7) // 8) * 8


def topk_for(seq_len: int) -> int:
    return max(int(n_pages(seq_len) * TOPK_FRAC), MIN_TOPK, 1)


def budget(seq_len: int) -> tuple[int, int, int]:
    """``(k, probe, pages)``: the sectored step's pages from the history,
    its probe pages (1 where k is narrower than the buffer) and the
    buffer's pages (the exact step's budget)."""
    pages = padded_pages(seq_len)
    k = min(topk_for(seq_len), pages)
    return k, (1 if 0 < k < pages else 0), pages


def probe_page(position: torch.Tensor) -> torch.Tensor:
    """Round-robin probe page of a decode position."""
    return position % (position // PAGE + 1)


def select(table: torch.Tensor, position: torch.Tensor, k: torch.Tensor,
           probe: torch.Tensor, width: int):
    """Pages each (row, kv head) reads at ``position`` (B,): the page being
    written, the probe page where ``probe`` (B,) bool, then the highest
    table scores; pages past the fill never (ties to the lower page).
    ``k`` (B,) is each row's budget and ``width`` the largest. Returns
    ``(pages (B, G, width) ascending, kept (B, G, width) bool)``."""
    B, G, P = table.shape
    pages = torch.arange(P, device=table.device)
    cur = position // PAGE
    scores = table + RECENCY_BONUS * (pages[None] >= cur[:, None]).float()[
        :, None]
    probed = (pages[None] == probe_page(position)[:, None]) & probe[:, None]
    scores = scores + PROBE_BONUS * probed.float()[:, None]
    valid = pages[None] <= cur[:, None]
    scores = torch.where(valid[:, None], scores, -torch.inf)
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    top = order[..., :width]
    kept = torch.arange(width, device=table.device)[None, None] < k[:, None,
                                                                      None]
    # ascending within the kept ones; the dropped ones go last
    key = torch.where(kept, top, P + top)
    srt = torch.sort(key, dim=-1)
    top = torch.gather(top, -1, srt.indices)
    kept = torch.gather(kept.expand_as(top), -1, srt.indices)
    return top, kept


def update(table: torch.Tensor, pages: torch.Tensor,
           mass: torch.Tensor) -> torch.Tensor:
    """Fold a step's per-page attention mass into the table."""
    upd = torch.zeros_like(table).scatter_add_(-1, pages, mass)
    return table * EMA_DECAY + (1.0 - EMA_DECAY) * upd
