"""Analytic simulator: closed-form SDF scenes rendered by sphere tracing
straight into device memory (counterpart of naruto_tpu/sim/analytic.py).

The scene is a closed box room fitted to the mapping AABB (walls inset by a
margin) plus interior primitives, coloured by a smooth procedural field.
Rendering is 64 fixed sphere-tracing steps over all pixels.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from naruto_tpu_torch.config import MainConfig
from naruto_tpu_torch.geometry.erp import erp_ray_dirs
from naruto_tpu_torch.geometry.rays import get_camera_rays
from naruto_tpu_torch.geometry.voxel import world_grid
from naruto_tpu_torch.sim.base import Simulator
from naruto_tpu_torch.utils.printer import InfoPrinter

WALL_MARGIN = 0.15      # meters between mapping AABB and the walls
TRACE_ITERS = 64
HIT_EPS = 2e-3


def make_scene_sdf(bound: np.ndarray, preset: str = "box_room",
                   device="cpu"):
    """Returns sdf(p, t) -> [N] (positive in free space) and
    color(p) -> [N, 3] for points p [N, 3] on `device`. 'dynamic_room'
    adds a sphere orbiting the room centre with phase t."""
    lo = np.asarray(bound[:, 0] + WALL_MARGIN, dtype=np.float32)
    hi = np.asarray(bound[:, 1] - WALL_MARGIN, dtype=np.float32)
    center = (lo + hi) / 2.0
    size = hi - lo
    s1_c = center + size * np.asarray([0.25, 0.2, -0.25], np.float32)
    s1_r = float(np.min(size)) * 0.12
    s2_c = center + size * np.asarray([-0.25, -0.2, -0.15], np.float32)
    s2_r = float(np.min(size)) * 0.16
    box_c = center + size * np.asarray([0.0, 0.28, -0.3], np.float32)
    box_h = size * np.asarray([0.10, 0.08, 0.12], np.float32)
    orbit_r = float(np.min(size)) * 0.25

    def dt(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    lo_t, hi_t, s1_t, s2_t, box_t, boxh_t, ctr_t = map(
        dt, (lo, hi, s1_c, s2_c, box_c, box_h, center))
    k = dt(2.0 * np.pi / np.maximum(size, 1e-3))
    mult, phase = dt([3.0, 4.0, 5.0]), dt([0.0, 2.1, 4.2])

    def sdf(p: torch.Tensor, t: float = 0.0) -> torch.Tensor:
        room = torch.amin(torch.minimum(p - lo_t, hi_t - p), dim=-1)
        if preset == "empty_room":
            return room
        s1 = torch.linalg.norm(p - s1_t, dim=-1) - s1_r
        s2 = torch.linalg.norm(p - s2_t, dim=-1) - s2_r
        q = torch.abs(p - box_t) - boxh_t
        box = (torch.linalg.norm(torch.clamp(q, min=0.0), dim=-1)
               + torch.clamp(torch.amax(q, dim=-1), max=0.0))
        static = torch.minimum(torch.minimum(room, s1), torch.minimum(s2, box))
        if preset == "dynamic_room":
            dyn_c = ctr_t + dt([orbit_r * math.cos(t), orbit_r * math.sin(t),
                                0.0])
            dyn = torch.linalg.norm(p - dyn_c, dim=-1) - s1_r * 0.8
            return torch.minimum(static, dyn)
        return static

    def color(p: torch.Tensor) -> torch.Tensor:
        return torch.clamp(0.5 + 0.35 * torch.sin((p - lo_t) * k * mult + phase),
                           0.0, 1.0)

    return sdf, color


def _trace(sdf, origins, dirs_unit, max_t: float):
    """Sphere tracing. Returns (t [N], hit [N])."""
    t = torch.zeros(origins.shape[0], device=origins.device)
    for _ in range(TRACE_ITERS):
        t = t + torch.clamp(sdf(origins + dirs_unit * t[:, None]),
                            min=0.0) * 0.95
    hit = (sdf(origins + dirs_unit * t[:, None]) < HIT_EPS) & (t < max_t)
    return t, hit


class AnalyticSimulator(Simulator):
    def __init__(self, cfg: MainConfig, device="cuda",
                 printer: Optional[InfoPrinter] = None):
        super().__init__(cfg, printer)
        self.device = torch.device(device)
        bound = cfg.mapper.bound_np
        self.bound = bound
        self.sdf, self.color_fn = make_scene_sdf(
            bound, cfg.sim.analytic_scene, self.device)
        self.max_t = float(np.linalg.norm(bound[:, 1] - bound[:, 0])) * 1.5
        H, W = cfg.sim.pinhole_hw
        c = cfg.cam
        self._pin_dirs = torch.from_numpy(get_camera_rays(
            H, W, c.fx, c.fy, c.cx, c.cy).reshape(-1, 3)).to(self.device)
        self._pin_hw = (H, W)
        He, We = cfg.sim.erp_hw
        self._erp_dirs = erp_ray_dirs(He, We, self.device).reshape(-1, 3)
        self._erp_hw = (He, We)
        self.invalid = cfg.sim.invalid_depth_value

    @torch.no_grad()
    def _render(self, dirs_unit, c2w, phase):
        o = c2w[:3, 3].expand(dirs_unit.shape[0], 3)
        t, hit = _trace(lambda q: self.sdf(q, phase), o, dirs_unit,
                        self.max_t)
        return t, hit, self.color_fn(o + dirs_unit * t[:, None])

    def simulate(self, c2w, return_erp: bool = False):
        c2w = torch.as_tensor(np.asarray(c2w, dtype=np.float32),
                              device=self.device)
        phase = self.step * 0.1              # dynamic-object orbit phase
        R = c2w[:3, :3]
        norm = torch.linalg.norm(self._pin_dirs, dim=-1, keepdim=True)
        t, hit, color = self._render((self._pin_dirs / norm) @ R.T, c2w,
                                     phase)
        depth = torch.where(hit, t / norm[:, 0], 0.0)   # radial -> z-depth
        H, W = self._pin_hw
        color, depth = color.reshape(H, W, 3), depth.reshape(H, W)
        if not return_erp:
            return color, depth
        t, hit, erp_color = self._render(self._erp_dirs @ R.T, c2w, phase)
        He, We = self._erp_hw
        return (color, depth, erp_color.reshape(He, We, 3),
                torch.where(hit, t, self.invalid).reshape(He, We))

    @torch.no_grad()
    def gt_sdf(self, pts: np.ndarray) -> np.ndarray:
        p = torch.as_tensor(np.asarray(pts, np.float32), device=self.device)
        return self.sdf(p).cpu().numpy()

    @torch.no_grad()
    def gt_occupancy_volume(self, voxel_size: float) -> np.ndarray:
        """The scene's SDF on the mapping AABB's voxel grid [X, Y, Z],
        computed on the sim's device (host numpy out)."""
        grid = world_grid(self.bound, voxel_size)
        p = torch.from_numpy(grid.reshape(-1, 3)).to(self.device)
        return self.sdf(p).cpu().numpy().reshape(grid.shape[:3])
