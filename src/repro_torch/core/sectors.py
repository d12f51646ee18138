"""Sector bitmask utilities (Sectored DRAM §4); counterpart of the JAX
package's ``core/sectors.py``, in numpy on ``uint32``.

A *sector* is 1/8 of a DRAM row's MAT set == one 64-bit word of a 64 B cache
block (with 8 chips x 8 sectors, one sector from each chip stores one word).
Sector sets are bitmasks: bit i set => word/sector i enabled.

The DRAM-side hardware budget (paper §4.1/§8.2): sector bits ride in unused
bits of the PRE command encoding -- up to 14 bits per PRE, so 8 sectors fit
with 6 bits to spare. ``encode_pre``/``decode_pre`` model that packing.
"""

from __future__ import annotations

import numpy as np

#: sectors per DRAM cache line: a 64-byte line of eight 8-byte sectors,
#: each with its own enable bit (bits 8 and up of a mask are ignored)
NUM_SECTORS = 8
WORD_BYTES = 8  # one sector of a cache block, transferred in one burst beat
BLOCK_BYTES = NUM_SECTORS * WORD_BYTES  # 64 B cache block
PRE_SPARE_BITS = 14  # unused DDR4 PRE-command bits available for sector bits

FULL_MASK = (1 << NUM_SECTORS) - 1  # 0xFF: all sectors enabled (coarse-grained)

_U32 = np.uint32


def popcount8(mask) -> np.ndarray:
    """Population count of a sector mask (the paper's 34-gate popcount
    circuit, §4.2), as int32. Works on any integer array."""
    m = np.asarray(mask).astype(_U32)
    m = m - ((m >> _U32(1)) & _U32(0x55555555))
    m = (m & _U32(0x33333333)) + ((m >> _U32(2)) & _U32(0x33333333))
    m = (m + (m >> _U32(4))) & _U32(0x0F0F0F0F)
    return ((m * _U32(0x01010101)) >> _U32(24)).astype(np.int32)


def mask_from_offset(word_offset) -> np.ndarray:
    """Single-word sector mask for a load/store touching ``word_offset``."""
    return _U32(1) << np.asarray(word_offset).astype(_U32)


def mask_from_offsets(word_offsets, valid) -> np.ndarray:
    """OR of single-word masks for a batch of (offset, valid) pairs."""
    bits = np.where(valid, mask_from_offset(word_offsets), _U32(0)).astype(_U32)
    return np.bitwise_or.reduce(bits, axis=None)


def burst_length(mask) -> np.ndarray:
    """Variable Burst Length (§4.2): beats in the data burst == popcount of the
    sector mask. The 8x3 encoder walks only enabled Read-FIFO entries."""
    return popcount8(mask)


def encode_pre(row_bits, sector_mask) -> np.ndarray:
    """Pack sector bits into the spare field of a PRE command word (§4.1)."""
    return (np.asarray(row_bits).astype(_U32) << _U32(PRE_SPARE_BITS)) | (
        np.asarray(sector_mask).astype(_U32) & _U32(FULL_MASK))


def decode_pre(pre_word) -> tuple[np.ndarray, np.ndarray]:
    """Inverse of :func:`encode_pre` -> (row_bits, sector_mask)."""
    w = np.asarray(pre_word).astype(_U32)
    return w >> _U32(PRE_SPARE_BITS), w & _U32(FULL_MASK)


def expand_mask(mask) -> np.ndarray:
    """uint mask -> (..., 8) boolean per-sector array."""
    bits = np.arange(NUM_SECTORS, dtype=_U32)
    return ((np.asarray(mask)[..., None].astype(_U32) >> bits) & _U32(1)
            ).astype(bool)


def compress_mask(bits) -> np.ndarray:
    """(..., 8) boolean per-sector array -> uint32 mask."""
    weights = _U32(1) << np.arange(NUM_SECTORS, dtype=_U32)
    return np.sum(np.asarray(bits).astype(_U32) * weights, axis=-1, dtype=_U32)
