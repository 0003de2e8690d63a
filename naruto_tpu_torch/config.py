"""The run configuration: the JAX package's typed config tree, which is
plain Python and imports no jax, reused as it is. The port's modules and
chip_smoke.py reach the config tree only through this module."""
from naruto_tpu.config import MainConfig, make_config  # noqa: F401
