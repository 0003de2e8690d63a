"""Per-step artifact saver — the reference's observability story
(counterpart of naruto_tpu/visualization/saver.py), written by the port's
image codec.

Directory contract parity with NARUTOVisualizer (src/visualization/
naruto_visualizer.py:57-223) so the reference's offline replay tooling
conventions carry over:
    <result_dir>/<dataset>/<scene>/visualization/
        rgbd/{step:04d}.png            side-by-side RGB | jet depth
        pose/{step:04d}.npy            c2w 4x4
        planning_path/{step:04d}.npy   current path (K, 3 metric) or empty
        lookat_tgts/{step:04d}.npy     look-at targets (K, 3)
        state/{step:04d}.txt           planner FSM state
        color_mesh/{step:04d}.ply      every save_mesh_freq steps
        uncert_mesh/{step:04d}.ply
        README.txt                     manifest

The rgbd panel is the JAX package's bit for bit: the simulator's float
colour truncated by ``(clip * 255).astype(uint8)`` (not the engine's
rounded uint8 frame), and the depth clipped at its float64 99.5th
percentile (or cam.depth_trunc) and coloured by jet, all in numpy on the
host in the JAX package's order. The live window of ``vis.vis_rgbd`` needs
a GUI toolkit, which the port does not use: it says so once and goes on,
as the JAX saver does where there is no display.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from naruto_tpu_torch.config.schema import MainConfig
from naruto_tpu_torch.sim.base import to_host, truncate_color
from naruto_tpu_torch.utils.image_io import write_png
from naruto_tpu_torch.utils.printer import InfoPrinter
from naruto_tpu_torch.visualization.raster import jet

_MANIFEST = """NARUTO-TPU visualization artifacts
rgbd/           per-step RGB-D previews (png)
pose/           per-step camera-to-world poses (npy, RDF)
planning_path/  planned path vertices in metric coords (npy)
lookat_tgts/    uncertain look-at target locations (npy)
state/          planner FSM state (txt)
color_mesh/     periodic color mesh snapshots (ply)
uncert_mesh/    periodic uncertainty mesh snapshots (ply)
"""
SUBDIRS = ("rgbd", "pose", "planning_path", "lookat_tgts", "state",
           "color_mesh", "uncert_mesh")


def rgbd_panel(color: np.ndarray, depth: np.ndarray,
               depth_trunc: float) -> np.ndarray:
    """uint8 [H, 2W, 3] RGB | jet depth, as the JAX saver composes it."""
    d = depth.copy()
    d = np.clip(d, 0, min(np.percentile(d[d > 0], 99.5)
                          if (d > 0).any() else 1.0, depth_trunc))
    dn = d / (d.max() + 1e-9)
    djet = (jet(dn) * 255).astype(np.uint8)
    return np.concatenate([truncate_color(color), djet], axis=1)


class ArtifactSaver:
    def __init__(self, cfg: MainConfig,
                 printer: Optional[InfoPrinter] = None):
        self.cfg = cfg
        self.vcfg = cfg.vis
        self.printer = printer or InfoPrinter(quiet=True)
        self.step = 0
        self._live_said = False
        self.root = os.path.join(cfg.general.result_dir, cfg.general.dataset,
                                 cfg.general.scene, "visualization")
        for sub in SUBDIRS:
            os.makedirs(os.path.join(self.root, sub), exist_ok=True)
        with open(os.path.join(self.root, "README.txt"), "w") as f:
            f.write(_MANIFEST)

    def update_step(self, step: int) -> None:
        self.step = step

    def _p(self, sub: str, ext: str) -> str:
        return os.path.join(self.root, sub, f"{self.step:04d}.{ext}")

    def main(self, mapper, planner, color, depth, c2w) -> None:
        """One step's artifacts. color/depth: the simulator's float frame
        (tensors or arrays), or None where nothing rendered it."""
        v = self.vcfg
        if v.save_rgbd and color is not None:
            self._save_rgbd(to_host(color), to_host(depth))
        if v.save_pose:
            np.save(self._p("pose", "npy"), np.asarray(c2w))
        if v.save_planning_path:
            path = getattr(planner, "path", None) or []
            pts = (np.stack([planner.vox2loc(p) for p in path])
                   if path else np.zeros((0, 3)))
            np.save(self._p("planning_path", "npy"), pts)
        if v.save_lookat_tgts:
            tgts = getattr(planner, "lookat_tgts", None) or []
            np.save(self._p("lookat_tgts", "npy"),
                    np.stack(tgts) if tgts else np.zeros((0, 3)))
        if v.save_state:
            with open(self._p("state", "txt"), "w") as f:
                f.write(str(getattr(planner, "state", "")))
        if self.step % v.save_mesh_freq == 0:
            from naruto_tpu_torch.mesh.extract import save_mesh

            if v.save_color_mesh:
                save_mesh(mapper, self._p("color_mesh", "ply"),
                          voxel_size=v.save_mesh_voxel_size,
                          color_mode="color")
            if v.save_uncert_mesh:
                save_mesh(mapper, self._p("uncert_mesh", "ply"),
                          voxel_size=v.save_mesh_voxel_size,
                          color_mode="uncert")

    def _save_rgbd(self, color: np.ndarray, depth: np.ndarray) -> None:
        panel = rgbd_panel(color, depth, self.cfg.cam.depth_trunc)
        write_png(self._p("rgbd", "png"), panel)
        if self.vcfg.vis_rgbd:
            self._show_live()

    def _show_live(self) -> None:
        """The reference's live RGB | jet-depth window (visualize_rgbd,
        src/visualization/visualizer.py:67-106) needs a GUI toolkit: the
        port opens none, says so once, and goes on."""
        if self._live_said:
            return
        self._live_said = True
        print("[vis] vis_rgbd: the port opens no live window (no GUI "
              "toolkit); the panels are in " + os.path.join(self.root,
                                                            "rgbd"),
              flush=True)
