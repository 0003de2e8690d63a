"""Simulator interface (counterpart of naruto_tpu/sim/base.py).

simulate(c2w, return_erp=False) ->
    (color [H, W, 3] in [0, 1], depth [H, W] z-depth in meters)
 or (color, depth, erp_color [He, We, 3], erp_dist [He, We] radial
     distance, invalid -> sim.invalid_depth_value).
c2w is the mapper's RDF camera-to-world pose. The port's simulators return
tensors on their device.

frame(c2w) -> (uint8 colour [H, W, 3], depth [H, W]) on the device: the
frame as the engine hands it to the mapper. The colour is quantized where
the renderer's output lies (on the device for the analytic simulator, on
the host before the copy for the raycast one) by the same expression.

host_frame(c2w, quantize=True) -> (colour, depth) as host numpy arrays,
uint8 colour (f32 in [0, 1] without `quantize`) and f32 depth: only on the
simulators that make their frames on the host (raycast, replay), whose
``frame`` is this plus the copy. A passive run prefetches their frames
(sim/prefetch.py).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from naruto_tpu_torch.config import MainConfig
from naruto_tpu_torch.utils.printer import InfoPrinter


def quantize_color(color):
    """Float colour in [0, 1] -> uint8 (the mapper's frame_to_rays
    dequantizes it): a tensor on its device, or a host numpy array by the
    same f32 expression (the JAX package's host quantization)."""
    if isinstance(color, np.ndarray):
        return (np.clip(color, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    return (torch.clamp(color, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


def truncate_color(color: np.ndarray) -> np.ndarray:
    """Float colour in [0, 1] -> uint8 by truncation, as the JAX package's
    saver, capture and offline renders write images (``quantize_color``
    rounds)."""
    return (np.clip(color, 0, 1) * 255).astype(np.uint8)


def to_host(x) -> np.ndarray:
    """A tensor on any device, or anything array-like -> a numpy array on
    the host."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


class Simulator:
    def __init__(self, cfg: MainConfig,
                 printer: Optional[InfoPrinter] = None):
        self.cfg = cfg
        self.sim_cfg = cfg.sim
        self.printer = printer or InfoPrinter(quiet=True)
        self.step = 0

    def update_step(self, step: int) -> None:
        self.step = step

    def simulate(self, c2w, return_erp: bool = False):
        raise NotImplementedError

    def frame(self, c2w):
        """The engine's frame: (uint8 colour, depth) on the device."""
        color, depth = self.simulate(c2w)[:2]
        return quantize_color(color), depth

    def probe_erp_dist(self, c2w):
        """ERP distance map only (what collision probes consume)."""
        return self.simulate(c2w, return_erp=True)[3]
