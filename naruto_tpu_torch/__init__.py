"""naruto_tpu_torch: the PyTorch/CUDA port of naruto_tpu for NVIDIA Hopper.

Module paths mirror ``naruto_tpu`` (``ops/``, ``mapping/``, ``sim/``,
``utils/``); the JAX package is the reference each module is tested against.
This package imports torch and never jax. It reuses the JAX package's
jax-free modules as they are: ``naruto_tpu.config``,
``naruto_tpu.geometry.rays``/``.voxel`` and ``naruto_tpu.utils.printer``.
"""
