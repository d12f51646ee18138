"""repro_torch — the PyTorch/CUDA port of the sectored KV-cache serving path.

The JAX package ``repro`` is the reference; this package mirrors its module
names (``configs``, ``models``, ``runtime``, ``sample``, ``serve``,
``launch``, ``kernels``) so each counterpart is easy to find, and never
imports it (nor ``jax``). Every Pallas kernel of the reference is a
hand-written CUDA kernel for Hopper here (``csrc/``), built with ``nvcc``
at first use (``kernels/build.py``) and reached through
``kernels/ops.py``; the serving path runs the paged sectored-attention
kernel (``kernels/sectored_attention.py:sectored_attention_paged``).

Entry points run on the GPU unless the caller asks for the CPU
(``device="cpu"``); on the CPU every kernel wrapper takes its plain
PyTorch version.
"""
