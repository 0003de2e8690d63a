"""Differentiable pose representation for tracking and pose optimisation
(counterpart of naruto_tpu/mapping/pose_opt.py).

Behavioral contract from upstream Co-SLAM (the reference inherits
get_pose_representation / get_pose_param_optim / matrix_from_tensor /
tracking_render; `rot_rep: 'axis_angle'` in every shipped config):

  * a pose is optimized as (axis-angle rot [3], translation [3]);
  * matrix_from_tensor = Rodrigues' formula (differentiable);
  * tracking: initialize from a constant-speed motion model, run
    `tracking.iter` Adam steps on `tracking.sample` rays drawn away from the
    image border (ignore_edge_W/H), minimizing the mapping losses with the
    field frozen; keep the iterate with the lowest loss (`tracking.best`).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from naruto_tpu_torch.ops import device_const


def axis_angle_to_matrix(rot: torch.Tensor) -> torch.Tensor:
    """rot [..., 3] axis-angle -> [..., 3, 3] via Rodrigues.

    The unnormalized form R = I + s1 [r]x + s2 [r]x^2 with s1 = sin(a)/a,
    s2 = (1 - cos a)/a^2 and Taylor branches near a = 0 (the double-where
    pattern), so gradients are finite at the identity."""
    a2 = torch.sum(rot * rot, dim=-1, keepdim=True)
    small = a2 < 1e-12
    a2_safe = torch.where(small, torch.ones_like(a2), a2)
    a = torch.sqrt(a2_safe)
    s1 = torch.where(small, 1.0 - a2 / 6.0, torch.sin(a) / a)
    s2 = torch.where(small, 0.5 - a2 / 24.0, (1.0 - torch.cos(a)) / a2_safe)
    x, y, z = rot[..., 0], rot[..., 1], rot[..., 2]
    zero = torch.zeros_like(x)
    K = torch.stack([torch.stack([zero, -z, y], -1),
                     torch.stack([z, zero, -x], -1),
                     torch.stack([-y, x, zero], -1)], -2)
    eye = torch.eye(3, dtype=rot.dtype, device=rot.device).expand(K.shape)
    return eye + s1[..., None] * K + s2[..., None] * (K @ K)


def matrix_to_axis_angle(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 3] axis-angle (the log map)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos = torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)
    angle = torch.arccos(cos)
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                     R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1)
    sin = torch.sin(angle)[..., None]
    axis = w / torch.clamp(2.0 * sin, min=1e-8)
    small = (angle < 1e-6)[..., None]
    return torch.where(small, w / 2.0, axis * angle[..., None])


def matrix_from_tensor(rot: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """(axis-angle [N, 3], translation [N, 3]) -> [N, 4, 4] c2w."""
    n = rot.shape[0]
    top = torch.cat([axis_angle_to_matrix(rot), trans[:, :, None]], dim=-1)
    # a cached device constant: a host copy would wait for the device, and
    # a captured BA call cannot make one
    bottom = device_const((0.0, 0.0, 0.0, 1.0), rot.dtype,
                          rot.device).expand(n, 1, 4)
    return torch.cat([top, bottom], dim=1)


def pose_to_tensor(c2w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return matrix_to_axis_angle(c2w[..., :3, :3]), c2w[..., :3, 3]


class TrackingConfig(NamedTuple):
    iters: int = 10
    sample: int = 1024
    lr_rot: float = 1e-3
    lr_trans: float = 1e-3
    ignore_edge_w: int = 20
    ignore_edge_h: int = 20
    best: bool = True
    const_speed: bool = True


def const_speed_init(prev: torch.Tensor, prev2: torch.Tensor) -> torch.Tensor:
    """Constant-speed motion model: T_i ~= T_{i-1} (T_{i-2}^-1 T_{i-1}).
    The inverse is a general one, as jnp.linalg.inv (without the host sync
    of torch.linalg.inv's error check)."""
    return prev @ torch.linalg.inv_ex(prev2)[0] @ prev
