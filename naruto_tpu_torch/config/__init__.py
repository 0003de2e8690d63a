"""The run configuration: the port's own copy of naruto_tpu's typed config
tree (``schema``, ``presets``, ``make_config``/``load_config``/
``list_scenes``). A config built here equals the JAX package's field for
field (tests/test_torch_config.py)."""
from naruto_tpu_torch.config.schema import MainConfig
from naruto_tpu_torch.config.loader import (list_scenes, load_config,
                                           make_config)

__all__ = ["MainConfig", "list_scenes", "load_config", "make_config"]
