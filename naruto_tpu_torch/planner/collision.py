"""SDF volume interpolation (the part of naruto_tpu/planner/collision.py
that the port has so far: the trilinear interpolation of a voxel volume,
which colours the uncertainty mesh).

Coordinates are clamped to the volume, as in the JAX package.
"""
from __future__ import annotations

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
