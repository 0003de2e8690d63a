"""Equirectangular (ERP) geometry in torch: ray directions, warps,
depth <-> distance (counterpart of naruto_tpu/geometry/erp.py).

The reference uses these for collision sensing: the simulator's ERP plane
depth is turned into radial distance by warping to 6 skybox faces (90 deg
FoV), converting each face's plane depth to distance, and stitching back to
ERP. Invalid depths (<= 0) become 1e8.

Conventions (RDF camera frame: +x right, +y down, +z forward):
  * ERP pixel (v, u) in an [H, W] image maps to latitude
    theta = pi*(0.5 - (v+0.5)/H)  (top row ~ +pi/2, up)
    and longitude phi = 2*pi*((u+0.5)/W - 0.5)  (center column = forward).
  * direction = (cos(t)*sin(p), -sin(t), cos(t)*cos(p)).

Images are [H, W] or [H, W, C] float32 tensors; every function computes on
the device of its input (``device`` for the ones without an image).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _erp_ray_dirs_np(H: int, W: int) -> np.ndarray:
    v = (np.arange(H, dtype=np.float32) + 0.5) / H
    u = (np.arange(W, dtype=np.float32) + 0.5) / W
    theta = np.pi * (0.5 - v)               # latitude, +pi/2 at top
    phi = 2 * np.pi * (u - 0.5)             # longitude, 0 = forward
    ct, st = np.cos(theta), np.sin(theta)
    cp, sp = np.cos(phi), np.sin(phi)
    x = ct[:, None] * sp[None, :]
    y = -st[:, None] * np.ones_like(cp)[None, :]
    z = ct[:, None] * cp[None, :]
    return np.stack([x, y, z], axis=-1).astype(np.float32)


def erp_ray_dirs(H: int, W: int, device="cpu") -> torch.Tensor:
    """[H, W, 3] unit ray directions in the RDF camera frame, on `device`.
    A constant table: computed once on the host in f32 and copied."""
    return torch.from_numpy(_erp_ray_dirs_np(H, W)).to(device)


def dirs_to_erp_uv(dirs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unit dirs [..., 3] -> continuous ERP coords (v, u) in [0, 1]
    normalized units."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    theta = torch.arcsin(torch.clamp(-y, -1.0, 1.0))
    phi = torch.atan2(x, z)
    return 0.5 - theta / np.pi, phi / (2 * np.pi) + 0.5


def bilinear_sample_2d(img: torch.Tensor, v: torch.Tensor, u: torch.Tensor,
                       wrap_u: bool = False) -> torch.Tensor:
    """Sample img [H, W(, C)] at continuous pixel coords (v, u) in pixels.
    Border clamp in v; optional horizontal wrap (ERP longitude)."""
    H, W = img.shape[0], img.shape[1]
    v = torch.clamp(v, 0.0, H - 1.0)
    v0 = torch.clamp(torch.floor(v).long(), 0, H - 2)
    fv = v - v0
    if wrap_u:
        u = torch.remainder(u, W)
        u0 = torch.floor(u).long()
        fu = u - u0
        u0 = torch.remainder(u0, W)
        u1 = torch.remainder(u0 + 1, W)
    else:
        u = torch.clamp(u, 0.0, W - 1.0)
        u0 = torch.clamp(torch.floor(u).long(), 0, W - 2)
        fu = u - u0
        u1 = u0 + 1
    imgc = img[..., None] if img.ndim == 2 else img
    fu, fv = fu[..., None], fv[..., None]
    a = imgc[v0, u0] * (1 - fu) + imgc[v0, u1] * fu
    b = imgc[v0 + 1, u0] * (1 - fu) + imgc[v0 + 1, u1] * fu
    out = a * (1 - fv) + b * fv
    return out[..., 0] if img.ndim == 2 else out


def pinhole_dirs(H: int, W: int, fov_deg: float = 90.0,
                 device="cpu") -> torch.Tensor:
    """[H, W, 3] RDF unit dirs for a square-pixel pinhole with given FoV."""
    f = (W / 2.0) / np.tan(np.radians(fov_deg) / 2.0)
    u = torch.arange(W, dtype=torch.float32, device=device) - (W / 2.0 - 0.5)
    v = torch.arange(H, dtype=torch.float32, device=device) - (H / 2.0 - 0.5)
    ones = torch.ones((H, W), device=device)
    d = torch.stack([u[None, :] / f * ones, v[:, None] / f * ones, ones],
                    dim=-1)
    return d / torch.linalg.norm(d, dim=-1, keepdim=True)


def depth2dist(depth: torch.Tensor, fx: float, fy: float, cx: float,
               cy: float) -> torch.Tensor:
    """Pinhole plane depth [H, W] -> radial distance (the backprojection's
    norm)."""
    H, W = depth.shape
    u = torch.arange(W, dtype=torch.float32, device=depth.device)
    v = torch.arange(H, dtype=torch.float32, device=depth.device)
    x = (u[None, :] - cx) / fx
    y = (v[:, None] - cy) / fy
    return depth * torch.sqrt(x ** 2 + y ** 2 + 1.0)


def _face_rotations() -> np.ndarray:
    def rot_y(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])

    def rot_x(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])

    return np.stack([
        np.eye(3),                      # Front  (+z)
        rot_y(np.pi / 2),               # Right  (+x)
        rot_y(np.pi),                   # Back   (-z)
        rot_y(-np.pi / 2),              # Left   (-x)
        rot_x(-np.pi / 2),              # Up     (-y)
        rot_x(np.pi / 2),               # Down   (+y)
    ]).astype(np.float32)


# the 6 skybox faces (FRBLUD): rotations of face-local RDF dirs into the
# camera frame (host numpy [6, 3, 3])
FACE_ROTATIONS = _face_rotations()


def _as_tensor(a, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=like.device)


def e2p(erp_img: torch.Tensor, face_rot, face_hw: int,
        fov_deg: float = 90.0) -> torch.Tensor:
    """A perspective view of an ERP image: per-pixel dirs rotated into the
    camera frame, converted to ERP coords, bilinearly sampled (longitude
    wraps)."""
    H, W = erp_img.shape[0], erp_img.shape[1]
    dirs = pinhole_dirs(face_hw, face_hw, fov_deg, erp_img.device)
    v, u = dirs_to_erp_uv(dirs @ _as_tensor(face_rot, erp_img).T)
    return bilinear_sample_2d(erp_img, v * H - 0.5, u * W - 0.5, wrap_u=True)


def c2e(faces: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Cubemap [6, s, s(, C)] (FRBLUD) -> ERP [out_h, out_w(, C)]: per ERP
    pixel the face id and in-face coords, then a bilinear sample within the
    face."""
    s = faces.shape[1]
    f = s / 2.0
    dirs = erp_ray_dirs(out_h, out_w, faces.device)           # [H, W, 3]
    R = _as_tensor(FACE_ROTATIONS, faces)                      # [6, 3, 3]
    d_face = torch.einsum("fij,hwi->fhwj", R, dirs)            # [6, H, W, 3]
    z = d_face[..., 2]
    x = d_face[..., 0] / torch.clamp(z, min=1e-9) * f + (s / 2.0 - 0.5)
    y = d_face[..., 1] / torch.clamp(z, min=1e-9) * f + (s / 2.0 - 0.5)
    inside = (z > 1e-6) & (x >= -0.5) & (x <= s - 0.5) \
        & (y >= -0.5) & (y <= s - 0.5)
    best = torch.argmax(torch.where(inside, z, -torch.inf), dim=0)  # [H, W]
    sampled = torch.stack([bilinear_sample_2d(faces[i], y[i], x[i])
                           for i in range(6)])                 # [6, H, W(, C)]
    if faces.ndim == 4:
        idx = best[None, ..., None].expand(1, *sampled.shape[1:])
    else:
        idx = best[None]
    return torch.gather(sampled, 0, idx)[0]


def p2e_with_pose(persp: torch.Tensor, R, out_h: int, out_w: int,
                  fx: float, fy: float, cx: float, cy: float,
                  fill: float = 0.0) -> torch.Tensor:
    """Project a perspective image into an ERP panorama at rotation R: each
    ERP pixel's ray rotated into the camera frame, projected through the
    pinhole intrinsics and bilinearly sampled where it lands inside the
    image; `fill` elsewhere."""
    dirs = erp_ray_dirs(out_h, out_w, persp.device)
    d_cam = dirs @ _as_tensor(R, persp)                      # R^T d (R c2w)
    z = d_cam[..., 2]
    zs = torch.where(z > 1e-6, z, 1.0)
    u = d_cam[..., 0] / zs * fx + cx
    v = d_cam[..., 1] / zs * fy + cy
    H, W = persp.shape[0], persp.shape[1]
    inside = (z > 1e-6) & (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)
    sampled = bilinear_sample_2d(persp, v, u)
    if persp.ndim == 3:
        inside = inside[..., None]
    return torch.where(inside, sampled, fill)


def erp_depth_to_dist(erp_depth: torch.Tensor, face_hw: int = 256,
                      invalid_value: float = 1e8) -> torch.Tensor:
    """ERP plane depth -> ERP radial distance through the skybox: E2P to 6
    faces, each face's plane depth to distance, C2E back. Invalid (<= 0)
    -> invalid_value."""
    H, W = erp_depth.shape
    f = face_hw / 2.0
    cx = cy = face_hw / 2.0 - 0.5
    faces = [depth2dist(e2p(erp_depth, FACE_ROTATIONS[i], face_hw),
                        f, f, cx, cy) for i in range(6)]
    dist = c2e(torch.stack(faces), H, W)
    return torch.where(erp_depth <= 0.0, invalid_value, dist)
