"""Per-scene presets (the port's own copy of naruto_tpu/config/presets.py).

Scene AABBs and budgets extracted from the reference config tree
(configs/{Replica,MP3D,NARUTO}/<scene>/coslam.yaml `mapping.bound`;
num_iter from configs/default.py:11 and configs/MP3D/*/NARUTO.py:12).
"""
from __future__ import annotations

from typing import Dict, Tuple

Bound = Tuple[Tuple[float, float], Tuple[float, float], Tuple[float, float]]

# dataset -> scene -> AABB (meters)
SCENE_BOUNDS: Dict[str, Dict[str, Bound]] = {
    "Replica": {
        "office0": ((-2.2, 2.6), (-3.4, 2.1), (-1.4, 2.0)),
        "office1": ((-1.9, 3.1), (-1.6, 2.6), (-1.1, 1.8)),
        "office2": ((-3.5, 3.1), (-2.9, 5.4), (-1.3, 1.6)),
        "office3": ((-5.2, 3.6), (-6.0, 3.3), (-1.3, 1.9)),
        "office4": ((-1.3, 5.4), (-2.4, 4.3), (-1.3, 1.7)),
        "room0": ((-1.0, 7.0), (-1.3, 3.7), (-1.7, 1.4)),
        "room1": ((-5.6, 1.4), (-3.2, 2.8), (-1.6, 1.8)),
        "room2": ((-0.9, 6.0), (-3.3, 1.8), (-3.0, 0.7)),
    },
    "MP3D": {
        "GdvgFV5R1Z5": ((-6.8, 0.7), (-3.8, 3.6), (-0.05, 3.9)),
        "HxpKQynjfin": ((-1.0, 5.0), (-8.3, 1.6), (-0.2, 2.8)),
        "YmJkqBEsHnH": ((-16.2, 4.1), (-5.5, 1.3), (-0.5, 6.0)),
        "gZ6f7yhEvPG": ((-4.1, 3.6), (-2.8, 3.0), (-0.5, 5.3)),
        "pLe4wQe7qrG": ((-2.3, 9.2), (-3.7, 3.8), (-0.5, 10.5)),
    },
    "NARUTO": {
        "hokage_room": ((-15.0, 7.5), (-10.5, 11.5), (-0.5, 5.7)),
        "jiraiya": ((-3.05, 3.05), (-3.05, 3.05), (-3.05, 3.05)),
        "naruto": ((-2.6, 2.6), (-2.6, 2.6), (-2.6, 2.6)),
    },
}

# NARUTO object scenes use a tighter marching-cubes bound than the map bound
MC_BOUNDS: Dict[str, Dict[str, Bound]] = {
    "NARUTO": {
        "jiraiya": ((-2.20, 1.95), (-2.45, 2.25), (-2.45, 1.55)),
        "naruto": ((-0.65, 0.75), (-0.5, 0.9), (-1.4, 1.65)),
    }
}

NUM_ITERS: Dict[str, int] = {"Replica": 2000, "MP3D": 5000, "NARUTO": 2000}

# Per-scene initial camera pose (RDF c2w) — ref configs/<ds>/<scene>/
# NARUTO.py `start_c2w`. Replica scenes start at identity
# (configs/Replica/*/NARUTO.py:48); MP3D scenes 1m up the z axis
# (configs/MP3D/*/NARUTO.py:44-48); NARUTO object scenes look along +y
# from outside the object (configs/NARUTO/*/NARUTO.py).
_EYE = ((1.0, 0.0, 0.0, 0.0), (0.0, 1.0, 0.0, 0.0),
        (0.0, 0.0, 1.0, 0.0), (0.0, 0.0, 0.0, 1.0))
_MP3D_START = ((1.0, 0.0, 0.0, 0.0), (0.0, 1.0, 0.0, 0.0),
               (0.0, 0.0, 1.0, 1.0), (0.0, 0.0, 0.0, 1.0))
START_C2W: Dict[str, Dict[str, tuple]] = {
    "Replica": {s: _EYE for s in SCENE_BOUNDS["Replica"]},
    "MP3D": {s: _MP3D_START for s in SCENE_BOUNDS["MP3D"]},
    "NARUTO": {
        "hokage_room": ((1.0, 0.0, 0.0, 0.0), (0.0, 0.0, -1.0, -1.0),
                        (0.0, 1.0, 0.0, 2.0), (0.0, 0.0, 0.0, 1.0)),
        "jiraiya": ((1.0, 0.0, 0.0, 0.0), (0.0, 0.0, -1.0, -2.9),
                    (0.0, 1.0, 0.0, 0.0), (0.0, 0.0, 0.0, 1.0)),
        "naruto": ((1.0, 0.0, 0.0, 0.0), (0.0, 0.0, -1.0, -2.4),
                   (0.0, 1.0, 0.0, 0.0), (0.0, 0.0, 0.0, 1.0)),
    },
}

# Per-scene non-default knobs from the reference experiment configs.
SCENE_OVERRIDES: Dict[str, Dict[str, dict]] = {
    "MP3D": {
        # more incomplete scene -> higher invalid-ERP tolerance
        # (configs/MP3D/HxpKQynjfin/NARUTO.py planner section)
        "HxpKQynjfin": {"planner": {"invalid_region_ratio_thre": 0.8}},
    },
    "NARUTO": {
        # object scenes plan on a finer uncertainty volume and mesh at
        # finer voxels (configs/NARUTO/*/{NARUTO.py planner section,
        # coslam.yaml mesh section})
        "hokage_room": {"vis": {"save_mesh_voxel_size": 0.1},
                        "mesh": {"voxel_eval": 0.05, "voxel_final": 0.02},
                        # host-render-bound 22.5x22 m glb on a 1-core box:
                        # probe at 256x512 — detect_collision consumes only
                        # min/ratio statistics (PARITY.md #13)
                        "sim": {"probe_hw": (256, 512)}},
        "jiraiya": {"planner": {"voxel_size": 0.02},
                    "mapper": {"voxel_size": 0.02},
                    "vis": {"save_mesh_voxel_size": 0.05},
                    "mesh": {"voxel_eval": 0.02, "voxel_final": 0.01}},
        "naruto": {"planner": {"voxel_size": 0.02},
                   "mapper": {"voxel_size": 0.02},
                   "vis": {"save_mesh_voxel_size": 0.02},
                   "mesh": {"voxel_eval": 0.01, "voxel_final": 0.005}},
    },
}
