"""Pose source: planned (active) or predefined trajectory (passive); the
port's own copy of naruto_tpu/system/pose_loader.py on the port's config.

Behavioral contract from src/data/pose_loader.py (C28 in SURVEY.md):
  * Replica traj.txt rows are RUB c2w; the mapper consumes RDF, so columns
    1 and 2 of R are negated on load (pose_loader.py:78-91).
  * MP3D traj.txt rows are consumed raw (pose_loader.py:93-104).
  * Initial pose: trajectory[0] when use_traj_pose, else the configured
    start_c2w; z is clipped into the planner's rrt_z_range if set
    (pose_loader.py:106-142).
  * update_pose returns the planner's pose (active) or trajectory[step]
    (passive) (pose_loader.py:144-164).
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from naruto_tpu_torch.config.schema import MainConfig


def load_traj_file(path: str, dataset: str) -> List[np.ndarray]:
    poses = []
    with open(path) as f:
        for line in f:
            vals = list(map(float, line.split()))
            if len(vals) < 16:
                continue
            c2w = np.asarray(vals[:16], dtype=np.float32).reshape(4, 4)
            if dataset == "Replica":
                c2w[:3, 1] *= -1
                c2w[:3, 2] *= -1
            poses.append(c2w)
    return poses


class PoseLoader:
    def __init__(self, cfg: MainConfig):
        self.cfg = cfg
        self.traj: Optional[List[np.ndarray]] = None
        if cfg.use_traj_pose or not cfg.enable_active_planning:
            traj_path = os.path.join(cfg.sim.scene_path, "traj.txt")
            self.traj = load_traj_file(traj_path, cfg.general.dataset)

    def load_init_pose(self) -> np.ndarray:
        """Initial pose priority (ref pose_loader.py:106-142): active +
        use_traj_pose -> traj[0]; active -> configured start_c2w (identity
        if unset); passive -> traj[0]. z clipped to rrt_z_range if set."""
        if self.cfg.enable_active_planning and self.traj is None:
            if self.cfg.start_c2w is not None:
                c2w = np.asarray(self.cfg.start_c2w, dtype=np.float32).copy()
            else:
                c2w = np.eye(4, dtype=np.float32)
        else:
            c2w = self.traj[0].copy()
        zr = self.cfg.planner.rrt_z_range
        if zr is not None:
            bound = self.cfg.mapper.bound_np
            vs = self.cfg.planner.voxel_size
            c2w[2, 3] = np.clip(c2w[2, 3], zr[0] * vs + bound[2, 0],
                                zr[1] * vs + bound[2, 0])
        return c2w

    def update_pose(self, planned_c2w: np.ndarray, step: int) -> np.ndarray:
        if self.cfg.enable_active_planning:
            return np.asarray(planned_c2w, dtype=np.float32)
        return self.traj[step].copy()
