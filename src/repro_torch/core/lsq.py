"""LSQ Lookahead (paper §5.3.1); counterpart of the JAX package's
``core/lsq.py``, in numpy.

LSQ Lookahead accumulates the cache-block word offsets referenced by younger
in-flight load/store instructions into an older instruction's miss request:
when a load misses, every LSQ entry within the lookahead window that targets
the same block contributes its word bit to the request's sector bits.

In the episode model a word's visibility is its instruction distance from the
request that triggers the fetch: word *j* is merged into a request issued at
distance *d* iff ``d <= dist_j <= d + window``.

``cluster_requests`` computes the full fetch schedule of an episode: the
initial miss (possibly augmented by the Sector Predictor) plus the sequence
of *sector-miss* requests, each of which again merges its own lookahead
window. It takes any leading batch shape (all episodes of a core at once).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.sectors import NUM_SECTORS, compress_mask, popcount8

DIST_INF = np.int32(2**30)
MAX_EXTRA = NUM_SECTORS  # an episode can at most sector-miss once per word

_U32 = np.uint32
_BITS = np.arange(NUM_SECTORS, dtype=_U32)


def la_mask(dist, window) -> np.ndarray:
    """Sector bits visible in the LSQ at the initial miss (distance 0):
    words first referenced within ``window`` instructions. The triggering
    word itself has distance 0 and is always included."""
    return compress_mask(np.asarray(dist) <= np.int32(window))


def round_to_halves(mask) -> np.ndarray:
    """Burst-chop granularity (§8.4): any enabled sector pulls in its whole
    half-block (sectors 0-3 / 4-7)."""
    mask = np.asarray(mask)
    lo = np.where((mask & 0x0F) != 0, _U32(0x0F), _U32(0))
    hi = np.where((mask & 0xF0) != 0, _U32(0xF0), _U32(0))
    return lo | hi


def cluster_requests(used_mask, dist, m0, window, chop: bool = False):
    """Fetch schedule after the initial request ``m0``.

    Words in ``used_mask`` not covered by ``m0`` cause sector misses. Each
    sector miss fires at the distance of its earliest uncovered word (the
    *leader*) and merges every still-uncovered word within ``window``
    instructions after the leader (LSQ Lookahead at the sector miss).

    ``used_mask`` and ``m0`` have shape ``(...)``, ``dist`` ``(..., 8)``.
    Returns ``(n_extra int32 (...), extra_masks uint32 (8, ...),
    extra_dists int32 (8, ...))``, the reference's scan layout; unused
    slots have mask 0 / dist DIST_INF.
    """
    window = np.int32(window)
    used = np.asarray(used_mask).astype(_U32)
    dist = np.asarray(dist).astype(np.int32)
    fetched = np.asarray(m0).astype(_U32)
    masks, dists = [], []
    for _ in range(MAX_EXTRA):
        uncovered = used & ~fetched
        ubits = ((uncovered[..., None] >> _BITS) & _U32(1)).astype(bool)
        d = np.where(ubits, dist, DIST_INF)
        leader_d = np.min(d, axis=-1)
        any_left = uncovered != 0
        lead = leader_d[..., None]
        clu = compress_mask((d >= lead) & (d <= lead + window))
        clu = np.where(any_left, clu, _U32(0))
        fetch = round_to_halves(clu) if chop else clu
        fetch = np.where(any_left, fetch, _U32(0)).astype(_U32)
        fetched = fetched | fetch
        masks.append(fetch)
        dists.append(np.where(any_left, leader_d, DIST_INF).astype(np.int32))
    masks = np.stack(masks)
    n_extra = np.sum((masks != 0).astype(np.int32), axis=0, dtype=np.int32)
    return n_extra, masks, np.stack(dists)


def extra_words_basic(used_mask) -> np.ndarray:
    """Sector misses of the *basic* configuration (single-word fetches, no
    LA, no SP): one extra DRAM access per used word beyond the first."""
    return popcount8(used_mask) - 1
