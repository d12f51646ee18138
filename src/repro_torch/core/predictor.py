"""Sector Predictor (paper §5.3.2) and the stage-1 prediction simulation;
counterpart of the JAX package's ``core/predictor.py``, in numpy.

The Sector Predictor (SP) associates the set of words used during a cache
block's L1 residency with the *signature* of the memory instruction that
fetched the block. The Sector History Table (SHT) is indexed by XOR-folding
the instruction address with the word offset of the data address; on a miss
the indexed entry's *previously used sectors* are merged into the request's
sector bits; on eviction the entry is overwritten with the residency's
*currently used sectors*.

``simulate_prediction`` runs the full stage-1 pipeline for one core:
episode stream -> (SHT prediction | LSQ lookahead | triggering word) ->
initial fetch mask, sector-miss schedule, overfetch, writeback masks.
The reference carries the SHT through a scan over episodes, reading entry
``idx`` before writing it; so episode *i* is predicted the used mask of the
last earlier episode with the same index (0 if none). Here that is one
stable sort on the index and a shift within each group, and every other
step is vectorized over all episodes.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import lsq
from repro_torch.core.sectors import FULL_MASK, mask_from_offset, popcount8

SHT_DEFAULT_ENTRIES = 512  # paper Table 2: 512-entry Sector Predictor
LA_DEFAULT_WINDOW = 128  # paper Table 2: 128-entry LSQ Lookahead

_U32 = np.uint32


@dataclasses.dataclass(frozen=True)
class FetchPolicy:
    """What the memory controller fetches per miss — one per evaluated config.

    full_fetch=True reproduces the coarse-grained baseline (and HalfDRAM /
    HalfPage / FGA / PRA-reads, which all still move whole cache blocks).
    """

    name: str
    full_fetch: bool = False  # fetch all 8 words (coarse-grained access)
    la_window: int = 0  # LSQ Lookahead reach in instructions (0 = off)
    sp_entries: int = 0  # SHT entries (0 = SP off)
    chop: bool = False  # burst-chop granularity (half blocks, §8.4)
    fine_writebacks: bool = False  # PRA: write only dirty words

    @property
    def sectored(self) -> bool:
        return not self.full_fetch


BASELINE = FetchPolicy("baseline", full_fetch=True)
BASIC = FetchPolicy("basic")
LA16 = FetchPolicy("LA16", la_window=16)
LA128 = FetchPolicy("LA128", la_window=128)
LA2048 = FetchPolicy("LA2048", la_window=2048)
SP512 = FetchPolicy("SP512", sp_entries=512)
LA128_SP512 = FetchPolicy("LA128-SP512", la_window=LA_DEFAULT_WINDOW,
                          sp_entries=SHT_DEFAULT_ENTRIES)
CHOP_LA128_SP512 = FetchPolicy("chop", la_window=128, sp_entries=512, chop=True)
PRA_POLICY = FetchPolicy("pra", full_fetch=True, fine_writebacks=True)


def sht_index(pc, word_offset, n_entries: int) -> np.ndarray:
    """XOR-fold of instruction address and word offset (Fig. 8, item 2),
    in uint32 with wraparound."""
    h = (np.asarray(pc).astype(_U32) * _U32(2654435761)) ^ (
        np.asarray(word_offset).astype(_U32) * _U32(40503))
    return (h % _U32(n_entries)).astype(np.int32)


@dataclasses.dataclass
class PredictionResult:
    """Stage-1 outputs for one core (numpy arrays, length E or (E,8))."""

    m0: np.ndarray  # initial fetch mask per episode
    n_extra: np.ndarray  # sector-miss requests per episode
    extra_masks: np.ndarray  # (E, 8) fetch mask per sector miss
    extra_dists: np.ndarray  # (E, 8) instruction distance of each sector miss
    writeback_mask: np.ndarray  # words written back at eviction
    overfetch_words: np.ndarray  # fetched-but-unused words per episode
    fetched_words: np.ndarray  # total words moved DRAM->CPU per episode

    @property
    def total_requests(self) -> np.ndarray:
        return 1 + self.n_extra


def sht_predictions(idx: np.ndarray, used: np.ndarray) -> np.ndarray:
    """What the SHT holds at ``idx[i]`` when episode *i* reads it: the
    ``used`` of the last earlier episode with the same index, else 0."""
    order = np.argsort(idx, kind="stable")
    s_idx = idx[order]
    prev = np.zeros(len(idx), _U32)
    if len(idx) > 1:
        same = s_idx[1:] == s_idx[:-1]
        prev[1:] = np.where(same, used[order][:-1], _U32(0))
    pred = np.empty(len(idx), _U32)
    pred[order] = prev
    return pred


def simulate_prediction(trace, policy: FetchPolicy) -> PredictionResult:
    """Run stage 1 for one core's episode trace under ``policy``."""
    used = np.asarray(trace.used_mask).astype(_U32)
    dirty = np.asarray(trace.dirty_mask).astype(_U32)
    dist = np.asarray(trace.dist).astype(np.int32)
    first = np.asarray(trace.first_word)
    if policy.sp_entries > 0:
        pred = sht_predictions(sht_index(trace.pc, first, policy.sp_entries),
                               used)
    else:
        pred = np.zeros(len(used), _U32)
    m0 = pred | lsq.la_mask(dist, policy.la_window) | mask_from_offset(first)
    if policy.chop:
        m0 = lsq.round_to_halves(m0)
    if policy.full_fetch:
        m0 = np.full(len(used), FULL_MASK, _U32)
    m0 = m0.astype(_U32)
    n_extra, masks, dists = lsq.cluster_requests(
        used, dist, m0, policy.la_window, chop=policy.chop)
    fetched = m0 | np.bitwise_or.reduce(masks, axis=0)
    if policy.full_fetch and not policy.fine_writebacks:
        wb = _U32(FULL_MASK) * (dirty != 0).astype(_U32)
    else:
        wb = dirty
    return PredictionResult(
        m0=m0,
        n_extra=n_extra,
        extra_masks=np.ascontiguousarray(masks.T),  # (E, MAX_EXTRA)
        extra_dists=np.ascontiguousarray(dists.T),
        writeback_mask=wb,
        overfetch_words=popcount8(fetched & ~used),
        fetched_words=popcount8(fetched),
    )
