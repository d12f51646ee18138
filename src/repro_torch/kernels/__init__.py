"""Kernels of the port: CUDA sources in ``repro_torch/csrc``, each with a
wrapper, a launch counter and its plain PyTorch version in one module.

* ``ops`` — the entry point, counterpart of the JAX package's
  ``kernels/ops.py``: every kernel below, with launch counters;
* ``sectored_attention`` — paged sectored decode attention (bf16 and int8
  flavors), the serving path's kernel, and the same page steering over
  the head-major layout (f32 or bf16);
* ``vbl_gather`` — Variable Burst Length sector compaction;
* ``flash_attention`` — blocked flash attention, causal or not;
* ``quantized_kv`` — per-sector int8 quantization (plain torch ops);
* ``backend`` — device resolution; ``build`` — nvcc build + ctypes load.
"""
