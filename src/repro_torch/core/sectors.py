"""Sector geometry of the port (counterpart of the JAX package's
``core/sectors.py``, of which only these constants are needed so far)."""

#: sectors per DRAM cache line: a 64-byte line of eight 8-byte sectors,
#: each with its own enable bit (bits 8 and up of a mask are ignored)
NUM_SECTORS = 8
WORD_BYTES = 8  # one sector of a cache block, transferred in one burst beat
BLOCK_BYTES = NUM_SECTORS * WORD_BYTES  # 64 B cache block
