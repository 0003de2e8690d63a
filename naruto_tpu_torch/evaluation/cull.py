"""Frustum + occlusion mesh culling before evaluation (the port's own copy
of naruto_tpu/evaluation/cull.py).

Protocol parity with neural_slam_eval's cull_mesh.py --remove_occlusion
(GO-Surf strategy), invoked by the reference eval scripts
(scripts/evaluation/eval_replica.sh:60-66): a mesh vertex is kept iff some
trajectory frame sees it — it projects inside the image, lies in front of
the camera, and is not occluded (its depth is within `eps` of the observed
depth at that pixel). Faces survive iff all three vertices are kept.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np


def cull_mesh(verts: np.ndarray, faces: np.ndarray,
              poses: Sequence[np.ndarray], K: np.ndarray,
              hw: Tuple[int, int],
              depth_fn: Optional[Callable[[int], np.ndarray]] = None,
              eps: float = 0.03,
              subsample: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """poses: c2w RDF [4,4] per frame; K: [3,3]; hw: (H, W);
    depth_fn(i) -> [H,W] z-depth for occlusion (None = frustum-only)."""
    H, W = hw
    keep = np.zeros(len(verts), dtype=bool)
    v_h = np.concatenate([verts, np.ones((len(verts), 1))], axis=1)

    for i in range(0, len(poses), subsample):
        c2w = np.asarray(poses[i])
        w2c = np.linalg.inv(c2w)
        cam = v_h @ w2c.T            # [N, 4]
        z = cam[:, 2]
        front = z > 1e-6
        u = cam[:, 0] / np.where(front, z, 1.0) * K[0, 0] + K[0, 2]
        v = cam[:, 1] / np.where(front, z, 1.0) * K[1, 1] + K[1, 2]
        inside = front & (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)
        if depth_fn is not None:
            d = np.asarray(depth_fn(i))
            ui = np.clip(np.round(u).astype(int), 0, W - 1)
            vi = np.clip(np.round(v).astype(int), 0, H - 1)
            obs = d[vi, ui]
            visible = inside & ((z <= obs + eps) | (obs <= 0))
        else:
            visible = inside
        keep |= visible
        if keep.all():
            break

    new_idx = np.full(len(verts), -1, dtype=np.int64)
    new_idx[keep] = np.arange(keep.sum())
    fkeep = keep[faces].all(axis=1)
    new_faces = new_idx[faces[fkeep]].astype(np.int32)
    return verts[keep], new_faces
