"""Device resolution for the port's entry points and kernel wrappers.

Leaf module: the kernels import it, so it imports no kernel module back.

Counterpart of the JAX package's ``kernels/backend.py``, which resolves
``interpret=None`` to compiled Mosaic on a TPU and the interpreter
elsewhere. Its docstring records the bug that motivated it: a hard-coded
``interpret=True`` made a production caller silently run the kernel body
in Python. The port's rule keeps that failure impossible:

* an entry point's ``device=None`` means ``"cuda"``, and raises when no GPU
  is present — it never drops to the CPU on its own;
* a kernel wrapper takes its plain PyTorch version only for tensors that
  lie on the CPU; for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means the GPU.

    Raises ``RuntimeError`` when CUDA is asked for (explicitly or by
    default) and ``torch.cuda.is_available()`` is false.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            f"is false; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r} (cuda or cpu)")
    return dev


def uses_kernel(*tensors: torch.Tensor) -> bool:
    """True when a wrapper must launch its CUDA kernel, False when it must
    take the plain version (every tensor on the CPU). Mixed or other
    devices raise: there is no silent middle ground."""
    types = {t.device.type for t in tensors}
    if types == {"cpu"}:
        return False
    if types == {"cuda"} and len({t.device for t in tensors}) == 1:
        return True
    raise ValueError(
        f"kernel inputs must all lie on one CUDA device or all on the CPU; "
        f"got {sorted(str(t.device) for t in tensors)}")
