"""Voxel grid helpers (the port's own copy of naruto_tpu/geometry/voxel.py).

Behavioral contract from upstream Co-SLAM `getVoxels` (import sites:
src/slam/coslam/coslam_utils.py:33, src/planner/rrt.py:9): per-axis
  N = round((max - min) / voxel_size + 0.0005); axis = linspace(min, max, N+1)
so a bbox of length L at voxel v yields round(L/v)+1 grid points per axis.
The same formula sizes the planner volume (naruto_planner.py:116-118) and the
uncertainty grid (scene_rep.py:50-52).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def axis_count(lo: float, hi: float, voxel_size: float) -> int:
    return int(round((hi - lo) / voxel_size + 0.0005)) + 1


def volume_shape(bound: np.ndarray, voxel_size: float) -> Tuple[int, int, int]:
    bound = np.asarray(bound)
    return tuple(axis_count(bound[i, 0], bound[i, 1], voxel_size)
                 for i in range(3))


def voxel_axes(bound: np.ndarray, voxel_size: float):
    """Per-axis linspace grids (tx, ty, tz), matching getVoxels."""
    bound = np.asarray(bound, dtype=np.float32)
    return tuple(
        np.linspace(bound[i, 0], bound[i, 1],
                    axis_count(bound[i, 0], bound[i, 1], voxel_size),
                    dtype=np.float32)
        for i in range(3)
    )


def world_grid(bound: np.ndarray, voxel_size: float) -> np.ndarray:
    """Dense [X, Y, Z, 3] world-coordinate grid over the bbox."""
    tx, ty, tz = voxel_axes(bound, voxel_size)
    gx, gy, gz = np.meshgrid(tx, ty, tz, indexing="ij")
    return np.stack([gx, gy, gz], axis=-1).astype(np.float32)


def vox2loc(vox: np.ndarray, bound: np.ndarray, voxel_size: float) -> np.ndarray:
    """Voxel -> metric coords (ref: src/planner/planner.py:85-100)."""
    return np.asarray(vox) * voxel_size + np.asarray(bound)[:, 0]


def loc2vox(loc: np.ndarray, bound: np.ndarray, voxel_size: float) -> np.ndarray:
    """Metric -> voxel coords (continuous; ref: planner.py:102-117)."""
    return (np.asarray(loc) - np.asarray(bound)[:, 0]) / voxel_size


def normalize_points(pts, bound):
    """Normalize world points into [0,1]^3 within the AABB (the field's input
    domain — ref: run_network / coslam_utils.py:82)."""
    bound = np.asarray(bound) if isinstance(pts, np.ndarray) else bound
    lo = bound[:, 0]
    hi = bound[:, 1]
    return (pts - lo) / (hi - lo)
