"""Counter-based per-request RNG (counterpart of the JAX package's
``sample/rng.py``): every draw comes from a key that is a pure function of
``(request_seed, position)``, so a token does not depend on the slot, the
wave's other requests or the scheduler.

The reference derives its keys with ``jax.random`` on the default
``threefry2x32`` implementation; this module reproduces that derivation
bit for bit in integer torch ops (never ``torch.Generator``):

* :func:`threefry2x32` — the Threefry-2x32 hash (20 rounds, key schedule
  every 4), the body of ``jax._src.prng._threefry2x32_lowering``;
* :func:`PRNGKey` — ``threefry_seed``: ``[seed >> 32, seed & 0xFFFFFFFF]``,
  ``[0, seed]`` for a uint32 seed;
* :func:`fold_in` — ``threefry2x32(key, threefry_seed(data))``;
* :func:`random_bits` — 32-bit draws in the *partitionable* layout the
  reference runs with (``jax_threefry_partitionable``): the counter of
  element ``i`` is the 64-bit ``i`` split into ``(hi, lo)`` words, and
  the bits are ``out_hi ^ out_lo``;
* :func:`uniform` and :func:`gumbel` — ``jax.random.uniform`` (mantissa
  bits OR ``0x3F800000``, minus 1, scaled, clamped at ``minval``) and
  ``jax.random.gumbel`` in mode ``"low"``.

Lanes are carried in ``int64`` holding uint32 values, masked to 32 bits
after every add and shift (torch's ``uint32`` lacks most operators,
on CUDA especially), so the CPU and the card compute the same bits. Keys
are ``(..., 2)`` tensors and every function is batched over the leading
axes (a wave's slots), with no host sync: it runs inside a captured wave.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA  # Threefry's key-schedule parity constant
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_ONE_BITS = 0x3F800000
_F32_MANTISSA = 23
_F32_TINY = torch.finfo(torch.float32).tiny


def _u32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int64) & MASK32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 of the counter words ``(x0, x1)`` under key
    ``(k0, k1)``; every argument holds uint32 values in int64 and they
    broadcast together. Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def PRNGKey(seed) -> torch.Tensor:
    """``jax.random.PRNGKey`` of uint32 seeds: ``(..., 2)`` int64 keys
    ``[seed >> 32, seed & 0xFFFFFFFF]``, i.e. ``[0, seed]``."""
    seed = torch.as_tensor(seed, dtype=torch.int64)
    return torch.stack([(seed >> 32) & MASK32, seed & MASK32], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: the hash of ``PRNGKey(data)`` under ``key``
    (``data`` is taken as uint32, as the reference converts it)."""
    data = _u32(torch.as_tensor(data).to(key.device))
    o0, o1 = threefry2x32(key[..., 0], key[..., 1],
                          torch.zeros_like(data), data)
    return torch.stack([o0, o1], dim=-1)


def token_key(seed, position) -> torch.Tensor:
    """The key of one token draw: ``fold_in(PRNGKey(seed), position)``.
    ``seed`` and ``position`` broadcast; keys are ``(..., 2)`` int64."""
    seed = torch.as_tensor(seed)
    position = torch.as_tensor(position).to(seed.device)
    return fold_in(PRNGKey(seed), position)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` per key: ``(..., n)`` int64
    holding uint32, in the partitionable counter layout (element ``i``
    hashes the counter words ``(i >> 32, i & 0xFFFFFFFF)``)."""
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    o0, o1 = threefry2x32(key[..., 0, None], key[..., 1, None],
                          (idx >> 32) & MASK32, idx & MASK32)
    return o0 ^ o1


def _bits_to_f32(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits (in int64) -> f32 in ``[1, 2)`` from the top 23 bits."""
    word = (bits >> (32 - _F32_MANTISSA)) | _F32_ONE_BITS
    return word.to(torch.int32).view(torch.float32)


def uniform(key: torch.Tensor, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval, maxval)`` per key:
    ``(..., n)`` f32 in ``[minval, maxval)``.

    The bounds and their span are rounded to f32 on the host, as the
    reference rounds them, and enter as Python scalars: a tensor made
    from a host value would be a host-to-device copy, which a CUDA graph
    capture refuses."""
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    floats = _bits_to_f32(random_bits(key, n)) - 1.0
    return torch.clamp_min(floats * span + lo, lo)


def gumbel(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32)`` (mode ``"low"``) per key:
    ``-log(-log(u))`` with ``u`` uniform in ``[tiny, 1)``. The logs are
    torch's, which may differ from XLA's by an ulp."""
    u = uniform(key, n, minval=_F32_TINY, maxval=1.0)
    return -torch.log(-torch.log(u))
