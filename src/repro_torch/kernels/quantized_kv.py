"""Per-sector int8 KV quantization — the software analog of narrower VBL
bursts (counterpart of the JAX package's ``kernels/quantized_kv.py``).

Scales are per (sequence, page, kv-head): one f32 per sector per head, so
a sector stays the atomic fetch unit — its payload and its scale travel
together, and the int8 flavor of ``csrc/sectored_attention_paged.cu``
dequantizes inside its f32 accumulate. The bf16 cache stays the master
copy; quantization happens at fetch time. Plain torch ops, as in JAX.
"""

from __future__ import annotations

import torch

INT8_MAX = 127.0
#: bytes per quantized KV word (int8) vs the bf16 master cache
KV_QUANT_BYTES = 1
#: the documented quality bound: teacher-forced logprob max-abs-err of the
#: fused_q8 path vs the dispatch path, on the reduced test config
LOGPROB_TOL = 0.1


def kv_word_fraction(kv_dtype_bytes: int = 2) -> float:
    """Fraction of a full-width KV word a quantized fetch moves: int8 over
    bf16 = 0.5."""
    return KV_QUANT_BYTES / float(kv_dtype_bytes)


def quantize_pages(pages: torch.Tensor):
    """Symmetric per-(sequence, page, kv-head) int8 quantization.

    pages: (B, P, page, Hkv, hd). Returns ``(q, scale)``: q int8 of the
    same shape, scale (B, P, Hkv) f32, with ``q * scale ~= pages``. Stale
    rows past the cache length are quantized too; they can inflate a
    page's scale but the kernels mask them to zero weight.
    """
    x = pages.float()
    amax = torch.amax(torch.abs(x), dim=(2, 4))
    scale = torch.clamp_min(amax, 1e-8) / INT8_MAX
    q = torch.round(x / scale[:, :, None, :, None])
    return torch.clamp(q, -INT8_MAX, INT8_MAX).to(torch.int8), scale


def dequantize_pages(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_pages` (f32), for oracles."""
    return q.float() * scale[:, :, None, :, None]
