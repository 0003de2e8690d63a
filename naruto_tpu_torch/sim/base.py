"""Simulator interface (counterpart of naruto_tpu/sim/base.py).

simulate(c2w, return_erp=False) ->
    (color [H, W, 3] in [0, 1], depth [H, W] z-depth in meters)
 or (color, depth, erp_color [He, We, 3], erp_dist [He, We] radial
     distance, invalid -> sim.invalid_depth_value).
c2w is the mapper's RDF camera-to-world pose. The port's simulators return
tensors on their device.
"""
from __future__ import annotations

from typing import Optional

from naruto_tpu_torch.config import MainConfig
from naruto_tpu_torch.utils.printer import InfoPrinter


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

    def probe_erp_dist(self, c2w):
        """ERP distance map only (what collision probes consume)."""
        return self.simulate(c2w, return_erp=True)[3]
