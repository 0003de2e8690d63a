"""Rotation planning: greedy nearest-rotation ordering + capped SLERP (the
port's own copy of naruto_tpu/planner/rotation.py).

Behavioral contract from src/planner/rotation_planning.py:74-192:
  * order the target rotations so each hop minimizes angular movement from
    the previous one (greedy);
  * interpolate each hop with SLERP in steps of at most max_rot_deg;
  * the flat output list INCLUDES the current rotation as its first element
    (so the first consumed rotation is a no-op step) and each target exactly
    once; the planner pops one matrix per timestep.
"""
from __future__ import annotations

from typing import List

import numpy as np
from scipy.spatial.transform import Rotation, Slerp


def angular_difference(r1: Rotation, r2: Rotation) -> float:
    return float((r1.inv() * r2).magnitude())


def minimize_movement(rotations: List[Rotation],
                      reference: Rotation) -> List[Rotation]:
    ordered = [reference]
    remaining = list(rotations)
    cur = reference
    while remaining:
        nxt = min(remaining, key=lambda r: angular_difference(cur, r))
        ordered.append(nxt)
        remaining.remove(nxt)
        cur = nxt
    return ordered


def interpolate_rotation(r1: Rotation, r2: Rotation,
                         step_deg: float) -> List[Rotation]:
    total_deg = angular_difference(r1, r2) / np.pi * 180.0
    num_steps = int(total_deg / step_deg)
    out = [r1]
    if num_steps >= 1:
        slerp = Slerp([0.0, 1.0], Rotation.concatenate([r1, r2]))
        for i in range(1, num_steps):
            out.append(slerp(i / num_steps))
    out.append(r2)
    return out


def rotation_planning(R_mat: np.ndarray, target_Rs_mat: List[np.ndarray],
                      max_rot_deg: float) -> List[np.ndarray]:
    ref = Rotation.from_matrix(np.asarray(R_mat))
    targets = [Rotation.from_matrix(np.asarray(m)) for m in target_Rs_mat]
    ordered = minimize_movement(targets, ref)
    planned: List[Rotation] = []
    for i in range(len(ordered) - 1):
        seg = interpolate_rotation(ordered[i], ordered[i + 1], max_rot_deg)
        planned.extend(seg if i == 0 else seg[1:])
    return [r.as_matrix().astype(np.float32) for r in planned]
