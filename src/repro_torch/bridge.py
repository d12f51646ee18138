"""Parameters of the JAX package, as numpy arrays, to the port's tensors.

The tests make parameters with the reference's ``model.init_params``,
turn every leaf into a numpy array, and hand the tree to
:func:`params_from_numpy`, so both implementations run on the same
weights bit for bit. A JAX bf16 array arrives as a numpy array whose
dtype is named ``bfloat16`` (itemsize 2, from ml_dtypes); it is carried
over through its 16-bit pattern — ``.view(np.uint16)`` then
``torch.Tensor.view(torch.bfloat16)`` — so no value is rounded on the way.
This module imports neither ``jax`` nor ``ml_dtypes``.

Like every entry point of the port, ``device=None`` means the GPU
(:func:`repro_torch.kernels.backend.resolve_device`) and raises where
there is none; the CPU tests pass ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.backend import resolve_device


def tensor_from_numpy(a: np.ndarray, device=None) -> torch.Tensor:
    """One array to a tensor on ``device``, bit for bit (bf16 via its
    16-bit pattern)."""
    device = resolve_device(device)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        if a.dtype.itemsize != 2:
            raise TypeError(f"bfloat16 array with itemsize "
                            f"{a.dtype.itemsize}")
        bits = np.ascontiguousarray(a).view(np.uint16)
        # torch has no uint16 view target on every version: go via int16
        t = torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    return t.to(device)


def params_from_numpy(tree, device=None):
    """A nested dict (or list) of numpy arrays -> the same structure of
    tensors on ``device``."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    return tensor_from_numpy(tree, device)


def tensor_to_numpy_bits(t: torch.Tensor) -> np.ndarray:
    """The raw bits of a tensor as a numpy array (bf16 as uint16), for
    bitwise comparisons in tests."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()
