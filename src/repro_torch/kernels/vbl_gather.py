"""Variable Burst Length (VBL) sector compaction: the CUDA kernel's wrapper
and its plain PyTorch version.

Counterpart of the JAX package's ``kernels/vbl_gather.py:vbl_gather``
(the Pallas ``_kernel``). Each row of ``data`` holds the 8 sectors of one
cache line; the row's mask says which sectors the burst carries. The
enabled sectors are packed to the front of the row in sector order — the
destination slot of sector ``s`` is the number of enabled sectors below
it, the paper's 8->3 encoder — and the remaining slots are zero. The
enabled count comes back too: a consumer moves only that many sectors,
the shortened burst.

* :func:`vbl_gather` — the wrapper. CPU tensors take
  :func:`vbl_gather_ref`; CUDA tensors launch ``csrc/vbl_gather.cu`` or
  raise. There is no fallback from one to the other.
* :func:`vbl_gather_ref` — the plain version.

Both copy bits, as the Pallas kernel does: a ``-0.0`` stays ``-0.0``
(the JAX package's ``ref.vbl_gather_ref`` adds into zeros and returns
``+0.0`` there). Only bits 0-7 of a mask are read; an int32 or int64 mask
is read through the same low bits as the uint32 it stands for.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.sectors import NUM_SECTORS
from repro_torch.kernels import backend, build

SOURCE = "vbl_gather"
#: element types the kernel moves (it copies 2- or 4-byte words)
DTYPES = (torch.float32, torch.bfloat16, torch.int32)
MASK_DTYPES = (torch.uint32, torch.int32, torch.int64)

#: kernel launches since the last :func:`reset_launches`
launches = {"vbl_gather": 0}


def reset_launches() -> None:
    launches["vbl_gather"] = 0


def _check(data: torch.Tensor, masks: torch.Tensor) -> None:
    if data.ndim != 3 or data.shape[1] != NUM_SECTORS:
        raise ValueError(f"data must be (N, {NUM_SECTORS}, W); got "
                         f"{tuple(data.shape)}")
    if tuple(masks.shape) != (data.shape[0],):
        raise ValueError(f"masks must be (N,) = ({data.shape[0]},); got "
                         f"{tuple(masks.shape)}")
    if data.dtype not in DTYPES:
        raise TypeError(f"data must be one of {DTYPES}; got {data.dtype}")
    if masks.dtype not in MASK_DTYPES:
        raise TypeError(f"masks must be one of {MASK_DTYPES}; got "
                        f"{masks.dtype}")


def vbl_gather_ref(data: torch.Tensor, masks: torch.Tensor):
    """Plain PyTorch version of :func:`vbl_gather` (same results, bit for
    bit). Masks are widened to int64 before the shift: CPU torch has no
    right shift for uint32."""
    _check(data, masks)
    sec = torch.arange(NUM_SECTORS, device=data.device)
    bits = ((masks.to(torch.int64)[:, None] >> sec) & 1).bool()
    dest = torch.cumsum(bits, dim=1) - 1
    rows, src = torch.nonzero(bits, as_tuple=True)
    out = torch.zeros_like(data)
    out[rows, dest[rows, src]] = data[rows, src]
    return out, bits.sum(dim=1, dtype=torch.int32)


@functools.cache
def _bind(lib: ctypes.CDLL):
    fn = lib.vbl_gather
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def vbl_gather(data: torch.Tensor, masks: torch.Tensor):
    """data (N, 8, W) f32, bf16 or int32; masks (N,) uint32 (or int32 /
    int64 holding the same bits) -> ``(packed (N, 8, W) in data.dtype,
    counts (N,) int32)``.

    CPU tensors take :func:`vbl_gather_ref`. CUDA tensors launch the
    kernel on the current stream (no synchronisation) and count the launch
    in ``launches``; anything the kernel does not take raises.
    """
    _check(data, masks)
    if not backend.uses_kernel(data, masks):
        return vbl_gather_ref(data, masks)
    if not data.is_contiguous() or not masks.is_contiguous():
        raise ValueError("vbl_gather kernel: data and masks must be "
                         "contiguous")
    if masks.dtype == torch.int64:
        masks = masks.to(torch.int32)  # keeps the low 32 bits
    N, _, W = data.shape
    out = torch.empty_like(data)
    counts = torch.empty((N,), dtype=torch.int32, device=data.device)
    if N == 0:
        return out, counts
    fn = _bind(build.load(SOURCE))
    stream = ctypes.c_void_p(
        torch.cuda.current_stream(data.device).cuda_stream)
    with torch.cuda.device(data.device):
        err = fn(ctypes.c_void_p(data.data_ptr()),
                 ctypes.c_void_p(masks.data_ptr()),
                 ctypes.c_void_p(out.data_ptr()),
                 ctypes.c_void_p(counts.data_ptr()),
                 N, W, data.element_size(), stream)
    if err != 0:
        raise RuntimeError(f"vbl_gather launch failed: CUDA error {err}")
    launches["vbl_gather"] += 1
    return out, counts
