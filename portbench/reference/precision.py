"""The precision the reference computes its products in.

``F32`` leaves every operand as it is: the reference. ``FP8`` rounds
each product's operands to float8 e4m3 with one scale per row of an
activation (its last dim) and per output column of a weight, and
multiplies them in float32: the control, the nearest precision below the
configurations' bfloat16.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


class F32:
    name = "float32"

    @staticmethod
    def act(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        return x

    @staticmethod
    def weight(w: torch.Tensor) -> torch.Tensor:
        """``w`` (in, out) as a float32 operand."""
        return w.float()


def _fp8(x: torch.Tensor, dim) -> torch.Tensor:
    x = x.float()
    scale = torch.clamp_min(x.abs().amax(dim=dim, keepdim=True),
                            1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class FP8:
    name = "float8_e4m3"

    @staticmethod
    def act(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        return _fp8(x, dim)

    @staticmethod
    def weight(w: torch.Tensor) -> torch.Tensor:
        return _fp8(w, 0)


PRECISIONS = {"float32": F32, "float8_e4m3": FP8}
