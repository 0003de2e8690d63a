"""The frames and poses every cell is fed: a frozen copy of the analytic
``box_room`` scene (a box room fitted to the mapping bound, two spheres and
a box inside, a procedural colour field) rendered by 64 fixed
sphere-tracing steps, and the recorded trajectory of ``data/traj_ab``.

This file is the benchmark's traffic generator and the reference's frame
source: it imports nothing of the program, so the frames both sides are
handed, and the frames the reference checks the program's own renders
against, come from here.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

WALL_MARGIN = 0.15      # metres between the mapping bound and the walls
TRACE_ITERS = 64
HIT_EPS = 2e-3


def load_trajectory(path: str) -> List[np.ndarray]:
    """Replica ``traj.txt`` rows (RUB camera-to-world, 16 numbers a row) as
    RDF camera-to-world matrices: columns 1 and 2 of R negated."""
    poses = []
    with open(path) as f:
        for line in f:
            vals = [float(v) for v in line.split()]
            if len(vals) < 16:
                continue
            c2w = np.asarray(vals[:16], np.float32).reshape(4, 4)
            c2w[:3, 1] *= -1
            c2w[:3, 2] *= -1
            poses.append(c2w)
    return poses


def camera_dirs(H: int, W: int, fx: float, fy: float, cx: float,
                cy: float) -> np.ndarray:
    """Per-pixel camera-frame directions of unit z-depth, [H*W, 3] f32,
    x right, y down, z forward."""
    u, v = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32), indexing="xy")
    dirs = np.stack([(u - cx) / fx, (v - cy) / fy, np.ones_like(u)], -1)
    return dirs.astype(np.float32).reshape(-1, 3)


class BoxRoom:
    """The analytic room of a mapping bound [3, 2], on `device`."""

    def __init__(self, bound, cam: dict, device):
        bound = np.asarray(bound, np.float32)
        lo = bound[:, 0] + WALL_MARGIN
        hi = bound[:, 1] - WALL_MARGIN
        center, size = (lo + hi) / 2.0, hi - lo

        def dt(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        self.lo, self.hi = dt(lo), dt(hi)
        self.s1 = dt(center + size * np.asarray([0.25, 0.2, -0.25], np.float32))
        self.r1 = float(np.min(size)) * 0.12
        self.s2 = dt(center + size * np.asarray([-0.25, -0.2, -0.15],
                                                np.float32))
        self.r2 = float(np.min(size)) * 0.16
        self.box = dt(center + size * np.asarray([0.0, 0.28, -0.3], np.float32))
        self.box_h = dt(size * np.asarray([0.10, 0.08, 0.12], np.float32))
        self.k = dt(2.0 * np.pi / np.maximum(size, 1e-3))
        self.mult, self.phase = dt([3.0, 4.0, 5.0]), dt([0.0, 2.1, 4.2])
        self.max_t = float(np.linalg.norm(bound[:, 1] - bound[:, 0])) * 1.5
        self.hw = (int(cam["H"]), int(cam["W"]))
        self.dirs = dt(camera_dirs(*self.hw, cam["fx"], cam["fy"], cam["cx"],
                                   cam["cy"]))

    def sdf(self, p: torch.Tensor) -> torch.Tensor:
        room = torch.amin(torch.minimum(p - self.lo, self.hi - p), dim=-1)
        s1 = torch.linalg.norm(p - self.s1, dim=-1) - self.r1
        s2 = torch.linalg.norm(p - self.s2, dim=-1) - self.r2
        q = torch.abs(p - self.box) - self.box_h
        box = (torch.linalg.norm(torch.clamp(q, min=0.0), dim=-1)
               + torch.clamp(torch.amax(q, dim=-1), max=0.0))
        return torch.minimum(torch.minimum(room, s1), torch.minimum(s2, box))

    def color(self, p: torch.Tensor) -> torch.Tensor:
        return torch.clamp(
            0.5 + 0.35 * torch.sin((p - self.lo) * self.k * self.mult
                                   + self.phase), 0.0, 1.0)

    @torch.no_grad()
    def frame(self, c2w) -> Tuple[torch.Tensor, torch.Tensor]:
        """(uint8 colour [H, W, 3], z-depth [H, W] f32, 0 where no hit) on
        the device, seen from the RDF camera-to-world pose c2w."""
        c2w = torch.as_tensor(np.asarray(c2w, np.float32),
                              device=self.dirs.device)
        norm = torch.linalg.norm(self.dirs, dim=-1, keepdim=True)
        d = (self.dirs / norm) @ c2w[:3, :3].T
        o = c2w[:3, 3].expand(d.shape[0], 3)
        t = torch.zeros(d.shape[0], device=d.device)
        for _ in range(TRACE_ITERS):
            t = t + torch.clamp(self.sdf(o + d * t[:, None]), min=0.0) * 0.95
        hit = (self.sdf(o + d * t[:, None]) < HIT_EPS) & (t < self.max_t)
        color = self.color(o + d * t[:, None])
        depth = torch.where(hit, t / norm[:, 0], 0.0)
        H, W = self.hw
        color = (torch.clamp(color, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
        return color.reshape(H, W, 3), depth.reshape(H, W)

