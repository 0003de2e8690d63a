"""Config construction and loading (the port's own copy of
naruto_tpu/config/loader.py).

  make_config(dataset, scene, **overrides) — programmatic, preset-backed
  load_config(path)                        — YAML file with `inherit_from`
                                             chaining and deep merge, matching
                                             the reference loader semantics
                                             (src/utils/config_utils.py:30-76)
"""
from __future__ import annotations

import os
from typing import Any, Dict, List

from naruto_tpu_torch.config import presets
from naruto_tpu_torch.config.schema import (
    GeneralConfig,
    MainConfig,
    deep_update,
)


def list_scenes() -> Dict[str, List[str]]:
    return {ds: sorted(sc.keys()) for ds, sc in presets.SCENE_BOUNDS.items()}


def make_config(dataset: str = "Replica", scene: str = "office0",
                seed: int = 0, num_iter: int | None = None,
                overrides: Dict[str, Any] | None = None) -> MainConfig:
    if dataset not in presets.SCENE_BOUNDS:
        raise KeyError(f"unknown dataset {dataset!r}; have {list(presets.SCENE_BOUNDS)}")
    if scene not in presets.SCENE_BOUNDS[dataset]:
        raise KeyError(f"unknown scene {scene!r} for {dataset}")

    bound = presets.SCENE_BOUNDS[dataset][scene]
    mc_bound = presets.MC_BOUNDS.get(dataset, {}).get(scene, bound)
    n_iter = num_iter if num_iter is not None else presets.NUM_ITERS[dataset]

    cfg = MainConfig(
        general=GeneralConfig(seed=seed, dataset=dataset, scene=scene,
                              num_iter=n_iter),
    )
    cfg = deep_update(cfg, {
        "mapper": {"bound": bound, "marching_cubes_bound": mc_bound},
        "start_c2w": presets.START_C2W.get(dataset, {}).get(scene),
    })
    scene_over = presets.SCENE_OVERRIDES.get(dataset, {}).get(scene)
    if scene_over:
        cfg = deep_update(cfg, scene_over)
    if overrides:
        cfg = deep_update(cfg, overrides)
    return cfg


def _load_yaml_with_inherit(path: str) -> Dict[str, Any]:
    """Recursive YAML loading with `inherit_from` chaining and deep merge —
    same contract as the reference load_config (config_utils.py:30-60)."""
    import yaml

    with open(path) as f:
        cfg_special = yaml.safe_load(f) or {}
    base_path = cfg_special.pop("inherit_from", None)
    if base_path:
        if not os.path.isabs(base_path):
            base_path = os.path.join(os.path.dirname(path), base_path)
        cfg = _load_yaml_with_inherit(base_path)
    else:
        cfg = {}
    _update_recursive(cfg, cfg_special)
    return cfg


def _update_recursive(dict1: Dict, dict2: Dict) -> None:
    """Reference update_recursive semantics (src/utils/config_utils.py:63-76)
    plus: an empty YAML section (`decoder:` -> None) means "no overrides" on
    either side of an inherit_from merge — it must never null out an
    inherited dict nor crash when the child later overrides into it."""
    for k, v in dict2.items():
        if v is None and isinstance(dict1.get(k), dict):
            continue                      # child's empty section: keep base
        if k not in dict1 or dict1[k] is None:
            dict1[k] = {} if isinstance(v, dict) else v
        if isinstance(v, dict):
            _update_recursive(dict1[k], v)
        else:
            dict1[k] = v


def load_config(path: str) -> MainConfig:
    """Load a YAML experiment file. Top-level keys mirror MainConfig fields;
    `dataset`/`scene` select a preset the rest overrides."""
    raw = _load_yaml_with_inherit(path)
    dataset = raw.pop("dataset", "Replica")
    scene = raw.pop("scene", "office0")
    seed = raw.pop("seed", 0)
    num_iter = raw.pop("num_iter", None)
    return make_config(dataset, scene, seed=seed, num_iter=num_iter,
                       overrides=raw)
