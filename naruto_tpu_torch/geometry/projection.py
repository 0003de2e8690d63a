"""Pinhole projection trio in torch: backprojection, projection, 3D
transform (counterpart of naruto_tpu/geometry/projection.py; the
reference's Backprojection, Projection and Transformation3D layers as
pure functions)."""
from __future__ import annotations

import torch


def backproject(depth: torch.Tensor, inv_K: torch.Tensor) -> torch.Tensor:
    """depth [H, W] -> homogeneous camera points [4, H*W]:
    p = depth * K^-1 [u, v, 1]^T, with a row of ones appended."""
    H, W = depth.shape
    kw = dict(dtype=depth.dtype, device=depth.device)
    v, u = torch.meshgrid(torch.arange(H, **kw), torch.arange(W, **kw),
                          indexing="ij")
    pix = torch.stack([u.reshape(-1), v.reshape(-1),
                       torch.ones(H * W, **kw)])               # [3, HW]
    cam = (inv_K[:3, :3] @ pix) * depth.reshape(1, -1)
    return torch.cat([cam, torch.ones((1, H * W), **kw)])


def project(points: torch.Tensor, K: torch.Tensor,
            eps: float = 1e-7) -> torch.Tensor:
    """Homogeneous points [4, N] -> pixel coords [N, 2]."""
    cam = K[:3, :3] @ points[:3]
    return (cam[:2] / torch.clamp(cam[2:3], min=eps)).T


def transform3d(T: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """[4, 4] @ [4, N] homogeneous transform."""
    return T @ points
