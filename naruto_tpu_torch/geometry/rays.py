"""Camera ray generation (the port's own copy of naruto_tpu/geometry/rays.py).

Behavioral contract from the upstream Co-SLAM `get_camera_rays` used by the
reference (import site: src/slam/coslam/coslam.py:30,144): per-pixel unit-z
("OpenCV"/RDF) ray directions from (H, W, fx, fy, cx, cy):
    d(u, v) = [(u - cx)/fx, (v - cy)/fy, 1].
Rays are NOT normalized — z-depth times direction gives the 3D point, which is
what the depth-guided sampler relies on.
"""
from __future__ import annotations

import numpy as np


def get_camera_rays(H: int, W: int, fx: float, fy: float,
                    cx: float | None = None, cy: float | None = None,
                    convention: str = "OpenCV") -> np.ndarray:
    """Returns [H, W, 3] float32 camera-frame ray directions (unit z-depth)."""
    if cx is None:
        cx = W / 2.0 - 0.5
    if cy is None:
        cy = H / 2.0 - 0.5
    u, v = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32), indexing="xy")
    x = (u - cx) / fx
    y = (v - cy) / fy
    z = np.ones_like(x)
    if convention == "OpenCV":      # RDF: +x right, +y down, +z forward
        dirs = np.stack([x, y, z], axis=-1)
    elif convention == "OpenGL":    # RUB: +x right, +y up, -z forward
        dirs = np.stack([x, -y, -z], axis=-1)
    else:
        raise ValueError(convention)
    return dirs.astype(np.float32)
