"""Trajectory length: sum of relative translations (the port's own copy of
naruto_tpu/evaluation/traj.py).

Protocol parity with src/evaluation/eval_traj_length.py:51-81.
"""
from __future__ import annotations

import numpy as np


def eval_traj_length(poses: np.ndarray) -> float:
    """poses: [N, 4, 4] c2w. Returns meters."""
    t = np.asarray(poses)[:, :3, 3]
    return float(np.linalg.norm(np.diff(t, axis=0), axis=1).sum())
