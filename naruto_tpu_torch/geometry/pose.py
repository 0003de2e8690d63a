"""Pose math: coordinate conventions and look-at rotations (the port's own
copy of naruto_tpu/geometry/pose.py, numpy only).

Conventions in play (from the reference system):
  * RDF (OpenCV): +x right, +y down, +z forward — the mapper's camera frame
    (rays have unit +z). Reference stores SLAM poses as camera-to-world RDF.
  * RUB (OpenGL): +x right, +y up, -z forward (backward = +z) — the planner &
    simulator frame. Reference converts RDF->RUB by negating rows 1:3
    (src/data/pose_loader.py:195-197) and plans look-at poses in RUB
    (src/planner/planner.py:119-153).

The flip diag(1,-1,-1) conjugates between the two camera frames; applied to a
c2w matrix it negates columns 1:2 of R (and nothing else):
  c2w_rub = c2w_rdf @ diag(1,-1,-1,1).
The reference's replica converter instead negates ROWS 1:3 of the whole matrix
(a world-frame flip specific to how Replica ground-truth trajectories were
exported); both are provided.
"""
from __future__ import annotations

import numpy as np

_FLIP = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)


def rdf_to_rub(c2w: np.ndarray) -> np.ndarray:
    """Camera-frame change RDF -> RUB (negate camera y/z basis columns)."""
    return (np.asarray(c2w) @ _FLIP).astype(np.float32)


def rub_to_rdf(c2w: np.ndarray) -> np.ndarray:
    return (np.asarray(c2w) @ _FLIP).astype(np.float32)


def replica_traj_to_rdf(c2w_rub_rows: np.ndarray) -> np.ndarray:
    """Replica traj.txt pose (RUB) -> mapper RDF pose; the reference negates
    columns 1 and 2 of the rotation (pose_loader.py:88-89)."""
    out = np.asarray(c2w_rub_rows, dtype=np.float32).copy()
    out[:3, 1] *= -1
    out[:3, 2] *= -1
    return out


def coslam_replica2habitat(pose: np.ndarray) -> np.ndarray:
    """Mapper RDF c2w -> habitat RUB agent pose for Replica assets: negate
    rows 1:3 (a world-frame flip baked into how the Replica ground truth was
    exported — ref pose_loader.py:195-207)."""
    out = np.asarray(pose, dtype=np.float32).copy()
    out[1:3, :] *= -1
    return out


def coslam_mp3d2habitat(pose: np.ndarray) -> np.ndarray:
    """Mapper RDF c2w -> habitat pose for MP3D assets: a +90deg world
    rotation about x with a matching translation swizzle
    (ref pose_loader.py:210-225)."""
    pose = np.asarray(pose, dtype=np.float32)
    T = np.array([[1, 0, 0, 0], [0, 0, 1, 0], [0, -1, 0, 0], [0, 0, 0, 1]],
                 dtype=np.float32)
    out = T @ pose
    out[1, 3] = pose[2, 3]
    out[2, 3] = -pose[1, 3]
    return out


def habitat_pose_conversion(pose: np.ndarray, method: str) -> np.ndarray:
    """Dispatch — ref pose_loader.py:167-188."""
    if method == "coslam_replica2habitat":
        return coslam_replica2habitat(pose)
    if method == "coslam_mp3d2habitat":
        return coslam_mp3d2habitat(pose)
    if method == "coslam_naruto2habitat":
        return np.asarray(pose, dtype=np.float32)
    raise NotImplementedError(method)


def lookat_rotation(eye: np.ndarray, target: np.ndarray,
                    up_dir: np.ndarray = np.array([0.0, 0.0, 1.0])) -> np.ndarray:
    """RUB/OpenGL look-at rotation with columns [right, up, backward].

    Behavioral parity with reference compute_camera_pose
    (src/planner/planner.py:119-153) including the degenerate-vertical fix:
    when eye and target share x,y the backward vector gets an epsilon x-tilt.
    """
    eye = np.asarray(eye, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    up_dir = np.asarray(up_dir, dtype=np.float64)

    back = eye - target                       # viewing direction (backward)
    if back[0] == 0 and back[1] == 0:
        back = back.copy()
        back[0] = 1e-6
    right = np.cross(up_dir, back)
    up = np.cross(back, right)
    back = back / np.linalg.norm(back)
    right = right / np.linalg.norm(right)
    up = up / np.linalg.norm(up)
    return np.column_stack((right, up, back)).astype(np.float32)


def transform_rays(rays_d_cam: np.ndarray, c2w: np.ndarray):
    """Rotate camera-frame ray dirs into world and broadcast origins.

    rays_d_cam: [..., 3]; c2w: [4, 4] (RDF camera-to-world).
    Returns (rays_o [..., 3], rays_d [..., 3]).
    """
    R = c2w[:3, :3]
    t = c2w[:3, 3]
    rays_d = rays_d_cam @ R.T
    rays_o = np.broadcast_to(t, rays_d.shape)
    return rays_o, rays_d


def pose_distance(T1: np.ndarray, T2: np.ndarray) -> tuple[float, float]:
    """(translation distance, rotation angle in radians) between two poses."""
    dt = float(np.linalg.norm(T1[:3, 3] - T2[:3, 3]))
    R = T1[:3, :3].T @ T2[:3, :3]
    cos = (np.trace(R) - 1.0) / 2.0
    dr = float(np.arccos(np.clip(cos, -1.0, 1.0)))
    return dt, dr
