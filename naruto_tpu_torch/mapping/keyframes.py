"""Keyframe ray database (counterpart of naruto_tpu/mapping/keyframes.py).

A fixed-capacity device buffer of [num_kf * rays_per_kf, 7] rays
(direction(3), rgb(3), depth(1)), allocated once and filled in place, one
slot per keyframe. The random draws are arguments:

  * ``add_keyframe`` takes one U[0, 1) score per pixel; invalid-depth pixels
    get +2, and the rays_per_kf smallest scores are kept (valid picks are
    recycled when a frame has fewer valid pixels than the quota). Ties keep
    the lower pixel index first, as ``jax.lax.top_k`` does.
  * ``sample_global_rays`` takes the ray indices, uniform in
    [0, count * rays_per_kf).
"""
from __future__ import annotations

from typing import Tuple

import torch


class KeyframeDB:
    def __init__(self, num_kf: int, rays_per_kf: int, device="cpu"):
        self.rays = torch.zeros((num_kf * rays_per_kf, 7), device=device)
        self.frame_ids = torch.full((num_kf,), -1, dtype=torch.int32,
                                    device=device)
        self.count = 0          # filled slots (host-side: adds are host-run)

    @property
    def rays_per_slot(self) -> int:
        return self.rays.shape[0] // self.frame_ids.shape[0]


def add_keyframe(db: KeyframeDB, frame_rays: torch.Tensor, frame_id: int,
                 score_u: torch.Tensor, depth_trunc: float = 100.0,
                 filter_depth: bool = True) -> KeyframeDB:
    """Fill slot db.count from frame_rays [H*W, 7] (in place); score_u
    [H*W] U[0, 1) picks the stored pixels."""
    n_pix = frame_rays.shape[0]
    quota = db.rays_per_slot
    depth = frame_rays[:, 6]
    if filter_depth:
        valid = (depth > 0.0) & (depth <= depth_trunc)
    else:
        valid = torch.ones((n_pix,), dtype=torch.bool, device=depth.device)
    score = score_u + torch.where(valid, 0.0, 2.0)
    idx = torch.sort(score, stable=True).indices[:quota]
    n_valid = torch.clamp(valid.sum(), min=1)
    pos = torch.arange(quota, device=depth.device)
    pos = torch.where(pos < valid.sum(), pos, pos % n_valid)
    slot = db.count
    db.rays[slot * quota:(slot + 1) * quota] = frame_rays[idx[pos]]
    db.frame_ids[slot] = frame_id
    db.count += 1
    return db


def sample_global_rays(db: KeyframeDB, idx: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rays at global indices idx [n] -> (rays [n, 7], keyframe slots [n])."""
    return db.rays[idx], idx // db.rays_per_slot
