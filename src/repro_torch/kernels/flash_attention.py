"""Blocked flash attention: the CUDA kernel's wrapper and its plain PyTorch
version.

Counterpart of the JAX package's ``kernels/flash_attention.py:
flash_attention`` (the Pallas ``_kernel``): attention over ``(B, H, S, hd)``
q, k and v (no grouped heads), causal or not, computed in f32 with an
online max/sum rescale and returned in ``q.dtype``.

* :func:`flash_attention` — the wrapper. CPU tensors take
  :func:`flash_attention_ref`; CUDA tensors launch
  ``csrc/flash_attention.cu`` or raise. There is no fallback from one to
  the other.
* :func:`flash_attention_ref` — the plain version: the JAX package's
  ``ref.flash_attention_ref`` (one softmax over the whole row), cast to
  ``q.dtype``.

``block_q``/``block_k`` are validated as the reference does
(``S % min(block, S) == 0``); the kernel picks its own tiling, which
changes only the order of the float sums.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import backend, build

NEG_INF = -1e30
SOURCE = "flash_attention"
FLAVORS = {torch.float32: "f32", torch.bfloat16: "bf16"}
#: head widths the kernel is built for (the reference's test widths)
HEAD_DIMS = (32, 64, 128)

#: kernel launches by input dtype since the last :func:`reset_launches`
launches = {flavor: 0 for flavor in FLAVORS.values()}


def reset_launches() -> None:
    for flavor in launches:
        launches[flavor] = 0


def _check(q, k, v, block_q: int, block_k: int) -> None:
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k and v must share one (B, H, S, hd) shape; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.dtype not in FLAVORS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must all be float32 or all bfloat16; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    S, hd = q.shape[2], q.shape[3]
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim must be one of {HEAD_DIMS}; got {hd}")
    for name, block in (("block_q", block_q), ("block_k", block_k)):
        if block < 1 or S % min(block, S):
            raise ValueError(f"S={S} must be a multiple of min({name}={block},"
                             f" S)")


def flash_attention_ref(q, k, v, causal: bool = True):
    """Plain PyTorch version of :func:`flash_attention`: f32 scores, one
    softmax over each (masked) row, f32 output contraction, cast to
    ``q.dtype``."""
    S, hd = q.shape[2], q.shape[3]
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    scores = scores / torch.sqrt(
        torch.full((), hd, dtype=torch.float32, device=q.device))
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, v.float()).to(q.dtype)


@functools.cache
def _bind(lib: ctypes.CDLL):
    fns = {}
    for flavor in FLAVORS.values():
        fn = getattr(lib, f"flash_attention_{flavor}")
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[flavor] = fn
    return fns


def flash_attention(q, k, v, causal: bool = True, block_q: int = 128,
                    block_k: int = 128):
    """q, k, v (B, H, S, hd) f32 or bf16, one dtype, hd in ``HEAD_DIMS`` ->
    (B, H, S, hd) in ``q.dtype``.

    CPU tensors take :func:`flash_attention_ref`. CUDA tensors launch the
    kernel on the current stream (no synchronisation) and count the launch
    in ``launches``; anything the kernel does not take raises.
    """
    _check(q, k, v, block_q, block_k)
    if not backend.uses_kernel(q, k, v):
        return flash_attention_ref(q, k, v, causal)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention kernel: {name} must be "
                             f"contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention kernel: {name} must be "
                             f"16-byte aligned (its tiles load in 16-byte "
                             f"copies)")
    B, H, S, hd = q.shape
    flavor = FLAVORS[q.dtype]
    out = torch.empty_like(q)
    fn = _bind(build.load(SOURCE))[flavor]
    stream = ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)
    with torch.cuda.device(q.device):
        err = fn(*(ctypes.c_void_p(t.data_ptr()) for t in (q, k, v, out)),
                 B * H, S, hd, int(bool(causal)), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_{flavor} launch failed: CUDA "
                           f"error {err}")
    launches[flavor] += 1
    return out
