"""SDF collision primitives, vectorized (the port's own copy of
naruto_tpu/planner/collision.py; numpy on the host, where the RRT runs).

Behavioral contract from src/planner/rrt.py:12-117:
  * a segment pa->pb is sampled every step_size/5 voxels (inclusive
    endpoints, count = ceil(len/(step/5)) + 1);
  * collision iff any sampled trilinear SDF <= collision_thre (0.5 voxel);
  * the returned prefix count is (#leading-free-samples - 1) // 5 — i.e. how
    many full step_size moves are safe (minimum 1 when fully free).
Coordinates are clamped to the volume, as in the JAX package.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def trilinear_interpolation_np(vol: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """vol [X,Y,Z]; pts [N,3] voxel coords -> [N] interpolated values."""
    pts = np.asarray(pts, dtype=np.float64)
    shape = np.asarray(vol.shape)
    c = np.clip(pts, 0.0, shape - 1.0)
    i0 = np.minimum(np.floor(c).astype(np.int64), shape - 2)
    f = c - i0
    x0, y0, z0 = i0[:, 0], i0[:, 1], i0[:, 2]
    fx, fy, fz = f[:, 0], f[:, 1], f[:, 2]

    def at(dx, dy, dz):
        return vol[x0 + dx, y0 + dy, z0 + dz]

    c00 = at(0, 0, 0) * (1 - fz) + at(0, 0, 1) * fz
    c01 = at(0, 1, 0) * (1 - fz) + at(0, 1, 1) * fz
    c10 = at(1, 0, 0) * (1 - fz) + at(1, 0, 1) * fz
    c11 = at(1, 1, 0) * (1 - fz) + at(1, 1, 1) * fz
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    return c0 * (1 - fx) + c1 * fx


def query_sdf_np(sdf_grid: np.ndarray, points: np.ndarray) -> np.ndarray:
    return trilinear_interpolation_np(sdf_grid, points)


def is_collision_free(pa: np.ndarray, pb: np.ndarray, sdf_map: np.ndarray,
                      step_size: float = 1.0,
                      collision_thre: float = 0.5) -> Tuple[int, bool]:
    """Returns (num_collision_free_steps, completely_free)."""
    pa = np.asarray(pa, dtype=np.float64)
    pb = np.asarray(pb, dtype=np.float64)
    n = int(np.ceil(np.linalg.norm(pb - pa) / (step_size / 5.0))) + 1
    points = np.linspace(pa, pb, num=n)
    vals = query_sdf_np(sdf_map, points)
    free = vals > collision_thre
    if free.all():
        return max((len(free) - 1) // 5, 1), True
    first_blocked = int(np.argmax(~free))
    return (first_blocked - 1) // 5, False
