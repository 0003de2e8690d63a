"""Replay simulator: serve RGB-D frames recorded on disk (counterpart of
naruto_tpu/sim/replay.py), decoded by the port's image codec.

The reference's passive-mapping path drives the SLAM from Replica-SLAM
data; this backend serves the same directory layout:
    <dir>/results/frame%06d.jpg   RGB (or .png)
    <dir>/results/depth%06d.png   depth, uint16 / cam.png_depth_scale meters
    <dir>/traj.txt                per-frame c2w (RUB rows; see PoseLoader)
The frame is the one of ``update_step``'s index; the requested pose is
ignored (the frames were recorded along the trajectory), as in the
reference. ``host_frame`` returns the decoded frame on the host: the uint8
colour, or with ``quantize=False`` the colour in [0, 1] (the uint8 over
255, as the JAX package divides); ``simulate`` and ``frame`` copy the one
or the other to the run's device. The uint8 colour equals
``quantize_color(simulate()[0])``.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from naruto_tpu_torch.config import MainConfig
from naruto_tpu_torch.sim.base import Simulator
from naruto_tpu_torch.utils.image_io import as_rgb, read_image, read_png
from naruto_tpu_torch.utils.printer import InfoPrinter


class ReplaySimulator(Simulator):
    def __init__(self, cfg: MainConfig, device="cuda",
                 printer: Optional[InfoPrinter] = None):
        super().__init__(cfg, printer)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ReplaySimulator(device='cuda') needs a CUDA "
                               "device and none is available")
        self.root = cfg.sim.scene_path
        self.results_dir = os.path.join(self.root, "results")
        if not os.path.isdir(self.results_dir):
            # some exports keep frames at the top level
            self.results_dir = self.root
        self.depth_scale = cfg.cam.png_depth_scale

    def _frame_paths(self, i: int):
        rgb = os.path.join(self.results_dir, f"frame{i:06d}.jpg")
        if not os.path.exists(rgb):
            rgb = os.path.join(self.results_dir, f"frame{i:06d}.png")
        depth = os.path.join(self.results_dir, f"depth{i:06d}.png")
        return rgb, depth

    def read(self):
        """The current step's (uint8 RGB [H, W, 3], f32 depth [H, W] in
        meters) on the host, decoded."""
        rgb_path, depth_path = self._frame_paths(self.step)
        for p in (rgb_path, depth_path):
            if not os.path.exists(p):
                raise FileNotFoundError(p)
        rgb = np.ascontiguousarray(as_rgb(read_image(rgb_path)))
        if rgb.dtype != np.uint8:         # 16-bit colour: cv2 keeps 8 bits
            rgb = (rgb >> 8).astype(np.uint8)
        depth_raw = read_png(depth_path)
        if depth_raw.ndim != 2:
            raise ValueError(f"{depth_path}: depth must be a one-channel "
                             f"PNG, not {depth_raw.shape}")
        depth = depth_raw.astype(np.float32) / self.depth_scale
        return rgb, depth

    def host_frame(self, c2w, quantize: bool = True):
        """The current step's frame on the host: (uint8 colour, or f32 in
        [0, 1] without `quantize`; f32 depth). What ``frame`` and
        ``simulate`` copy, and what sim/prefetch.py's worker makes."""
        rgb, depth = self.read()
        if not quantize:
            rgb = rgb.astype(np.float32) / np.float32(255.0)
        return rgb, depth

    def _to_device(self, rgb: np.ndarray, depth: np.ndarray):
        return (torch.from_numpy(rgb).to(self.device),
                torch.from_numpy(depth).to(self.device))

    def simulate(self, c2w, return_erp: bool = False):
        if return_erp:
            raise NotImplementedError(
                "replay data carries no ERP sensor; use analytic or raycast")
        return self._to_device(*self.host_frame(c2w, quantize=False))

    def frame(self, c2w):
        return self._to_device(*self.host_frame(c2w))
