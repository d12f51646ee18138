"""The yardstick's arithmetic: the card's peaks, the least time of a call,
the operations and bytes of a paged-attention call, counted from the
configuration's shapes (a decode step's FLOPs are its architecture's:
``archs/<architecture>.py``).

Frozen copies, so that a later change to the program cannot move the
measure: the peaks are NVIDIA's data sheet figures for one H100 SXM
(``launch/roofline.py`` and ``chip_smoke.py`` use the same), ``bound``
and ``paged_call`` are ``chip_smoke.py``'s ``bound`` and
``case_bytes_ops`` (each input read once, only the selected pages' valid
tokens of K and V, each output written once; 4·rep·hd operations per
valid token).
"""

from __future__ import annotations

BF16_FLOPS = 989e12  # dense tensor-core bf16, H100 SXM data sheet
HBM_BYTES_PER_S = 3.35e12  # HBM3, same data sheet
PAGE = 128  # tokens per KV page of the serving state


def bound(nbytes: float, ops: float, ops_per_s: float = BF16_FLOPS) -> dict:
    """The least time the card could take: bytes at the HBM rate or
    operations at ``ops_per_s``, whichever is longer (seconds)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / ops_per_s
    return dict(seconds=max(t_bytes, t_ops),
                by="bytes" if t_bytes >= t_ops else "operations")


def attended(count: int, pages: int) -> int:
    """Valid tokens a step reads when it selects ``pages`` pages of a
    sequence holding ``count`` tokens (the new one included): all of
    them where they fit, else the page being written and ``pages - 1``
    full pages."""
    n_valid = (count + PAGE - 1) // PAGE
    if n_valid <= pages:
        return count
    return (pages - 1) * PAGE + count - (n_valid - 1) * PAGE


def paged_call(counts: list, hkv: int, rep: int, hd: int, pages: int,
               kv_item: int = 2) -> tuple[int, int]:
    """Least bytes and operations of one paged-attention call over the
    wave's rows (``counts``: each row's tokens, the new one included)."""
    B = len(counts)
    tokens = hkv * sum(attended(c, pages) for c in counts)
    nbytes = (B * hkv * rep * hd * 2  # q, bf16
              + B * hkv * pages * 4 + B * 4  # page_idx, length
              + 2 * tokens * hd * kv_item  # K and V
              + B * hkv * rep * hd * 4 + B * hkv * pages * 4)  # out, mass
    return nbytes, 4 * rep * hd * tokens


def percentile(values: list, q: float) -> float | None:
    """The ``q``-th percentile, linear between the order statistics
    (numpy's default); None for no values."""
    import numpy as np
    values = np.asarray(values, dtype=np.float64)
    if not values.size:
        return None
    return float(np.percentile(values, q))
