"""Kernels of the port: CUDA sources in ``repro_torch/csrc``, each with a
wrapper, a launch counter and its plain PyTorch version in one module.

* ``sectored_attention`` — paged sectored decode attention (bf16 and int8
  flavors), the serving path's kernel;
* ``quantized_kv`` — per-sector int8 quantization (plain torch ops);
* ``backend`` — device resolution; ``build`` — nvcc build + ctypes load.
"""
