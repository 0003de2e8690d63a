"""Config construction (the port's own copy of ``make_config`` and
``list_scenes`` from naruto_tpu/config/loader.py).

  make_config(dataset, scene, **overrides) — programmatic, preset-backed
"""
from __future__ import annotations

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
