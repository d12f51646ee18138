"""The port's kernel entry point, counterpart of the JAX package's
``kernels/ops.py``: every hand-written CUDA kernel behind one import, with
the reference's argument names and order.

The reference's ``interpret`` argument has no counterpart: there is no
interpreter, and the tensors' device decides. CPU tensors take each
kernel's plain PyTorch version; CUDA tensors launch the kernel built from
``repro_torch/csrc`` or raise (mixed devices, and dtypes, shapes or head
widths a kernel does not take). Nothing falls back from one to the other.

:func:`launch_counts` and :func:`reset_launches` read and clear every
wrapper's launch counter at once, so a caller can show which kernels a run
went through.
"""

from __future__ import annotations

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import sectored_attention as _sa
from repro_torch.kernels import vbl_gather as _vbl
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.sectored_attention import (sectored_attention,
                                                    sectored_attention_paged)
from repro_torch.kernels.vbl_gather import vbl_gather

__all__ = ["flash_attention", "sectored_attention",
           "sectored_attention_paged", "vbl_gather", "launch_counts",
           "reset_launches"]


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last :func:`reset_launches`, by kernel
    and flavor (the names ``chip_smoke.py`` reports)."""
    counts = {f"sectored_attention_paged_{f}": n
              for f, n in _sa.launches.items()}
    counts.update({f"sectored_attention_{f}": n
                   for f, n in _sa.head_major_launches.items()})
    counts.update(_vbl.launches)
    counts.update({f"flash_attention_{f}": n
                   for f, n in _flash.launches.items()})
    return counts


def reset_launches() -> None:
    for module in (_sa, _vbl, _flash):
        module.reset_launches()
