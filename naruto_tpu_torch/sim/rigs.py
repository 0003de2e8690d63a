"""Multi-camera rig orientations for scripted data generation.

Parity with the reference's sensor-spec builders (habitat_utils.py:89-145:
pinhole orientation types 'skybox' (6 faces), 'horizontal' (ring of
num_rot), 'horizontal+UpDown'; and :253-297 multiview shifts & stereo
baselines). A rig is a list of (name, R_offset 3x3 RDF) applied on top of
the agent pose; `render_rig` drives any Simulator backend through it.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def _rot_y(deg: float) -> np.ndarray:
    a = np.radians(deg)
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=np.float32)


def _rot_x(deg: float) -> np.ndarray:
    a = np.radians(deg)
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], dtype=np.float32)


def rig_orientations(kind: str, num_rot: int = 4
                     ) -> List[Tuple[str, np.ndarray]]:
    """kind: 'skybox' | 'horizontal' | 'horizontal+UpDown' | 'mono'."""
    if kind == "mono":
        return [("front", np.eye(3, dtype=np.float32))]
    if kind == "skybox":
        return [("front", np.eye(3, dtype=np.float32)),
                ("right", _rot_y(90)), ("back", _rot_y(180)),
                ("left", _rot_y(-90)), ("up", _rot_x(-90)),
                ("down", _rot_x(90))]
    if kind == "horizontal":
        return [(f"rot{i}", _rot_y(360.0 * i / num_rot))
                for i in range(num_rot)]
    if kind == "horizontal+UpDown":
        ring = rig_orientations("horizontal", num_rot)
        return ring + [("up", _rot_x(-90)), ("down", _rot_x(90))]
    raise ValueError(f"unknown rig kind: {kind}")


def stereo_offsets(baseline: float = 0.2) -> List[Tuple[str, np.ndarray]]:
    """Left/right translation offsets (RDF x-axis), ref habitat_utils
    stereo placement."""
    return [("left", np.array([-baseline / 2, 0, 0], dtype=np.float32)),
            ("right", np.array([baseline / 2, 0, 0], dtype=np.float32))]


def render_rig(sim, c2w: np.ndarray, kind: str = "skybox",
               num_rot: int = 4,
               stereo_baseline: float = 0.0) -> Dict[str, tuple]:
    """Render every rig view at the agent pose. Returns
    {view_name: (color, depth)}."""
    c2w = np.asarray(c2w, dtype=np.float32)
    shifts = (stereo_offsets(stereo_baseline) if stereo_baseline > 0
              else [("", np.zeros(3, dtype=np.float32))])
    out = {}
    for sname, tvec in shifts:
        for rname, R in rig_orientations(kind, num_rot):
            pose = c2w.copy()
            pose[:3, :3] = c2w[:3, :3] @ R
            pose[:3, 3] = c2w[:3, 3] + c2w[:3, :3] @ tvec
            name = f"{sname}_{rname}".strip("_")
            out[name] = sim.simulate(pose)[:2]
    return out
