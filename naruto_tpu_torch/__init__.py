"""naruto_tpu_torch: the PyTorch/CUDA port of naruto_tpu for NVIDIA Hopper.

Module paths mirror ``naruto_tpu`` (``ops/``, ``mapping/``, ``sim/``,
``utils/``); the JAX package is the reference each module is tested against.
This package imports torch and nothing of jax or of ``naruto_tpu``, not
even its jax-free modules: it keeps its own copies of those it needs
(``config/``, ``geometry/rays.py``/``voxel.py``, ``utils/printer.py``).
"""
