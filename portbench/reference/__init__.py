"""The plain reference: each architecture's forward pass in plain PyTorch,
float32 with TF32 off, teacher-forced over a served request's prompt and
tokens, computed layer by layer. It imports neither the program nor its
JAX counterpart, and takes only the benchmark's weights and inputs:
what the program derives from them (the KV cache, the sector-history
table and the pages it selects, the recurrent state) it works out again,
with frozen copies of the arithmetic in ``predictor.py``.
"""

import torch


def exact_matmuls() -> None:
    """float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
