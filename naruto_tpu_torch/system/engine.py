"""The reconstruction engine's passive path: the sim -> map loop over a
predefined trajectory (counterpart of naruto_tpu/system/engine.py with
``enable_active_planning: false``).

Per step: update the module steps, take the trajectory's pose, get the
RGB-D frame (rendered ahead by a worker thread, sim/prefetch.py) and run one
mapping step. At the end, ``finalize`` writes the final mesh, the checkpoint,
the trajectory length, the analytic scene's ground-truth mesh and the metric
row (accuracy, completion, ratio, F-score, MAD) to ``eval_result.txt``, and
prints the timing breakdown.

Not ported yet, and refused: active planning (the planner, ROADMAP queue 1
items 7-8), the artifact saver of ``vis.enable_all_vis`` (item 8),
mid-run full-state checkpoints (``general.ckpt_freq``) and resuming from
them (item 5), and so ``planner_stats.json``, which the planner writes.
A failed evaluation fails the run.
"""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from naruto_tpu_torch.config.schema import MainConfig
from naruto_tpu_torch.evaluation import eval_mad, eval_mesh, eval_traj_length
from naruto_tpu_torch.mapping.mapper import Mapper
from naruto_tpu_torch.mesh.extract import save_mesh
from naruto_tpu_torch.mesh.marching import marching_cubes
from naruto_tpu_torch.mesh.ply import read_ply, write_ply
from naruto_tpu_torch.sim import init_simulator
from naruto_tpu_torch.sim.prefetch import FramePrefetcher
from naruto_tpu_torch.system.pose_loader import PoseLoader
from naruto_tpu_torch.utils.printer import InfoPrinter
from naruto_tpu_torch.utils.results import update_results_file
from naruto_tpu_torch.utils.timer import Timer


def _refuse_unported(cfg: MainConfig) -> None:
    if cfg.enable_active_planning:
        raise NotImplementedError(
            "enable_active_planning: true needs the planner, which is not "
            "ported yet (ROADMAP queue 1, items 7-8); the port runs the "
            "passive path (enable_active_planning: false)")
    if cfg.vis.enable_all_vis:
        raise NotImplementedError(
            "vis.enable_all_vis needs the artifact saver, which is not "
            "ported yet (ROADMAP queue 1, item 8)")
    if cfg.general.ckpt_freq:
        raise NotImplementedError(
            "general.ckpt_freq > 0 writes full-state snapshots, which are "
            "not ported yet (ROADMAP queue 1, item 5)")


class Engine:
    def __init__(self, cfg: MainConfig, device="cuda", quiet: bool = False):
        _refuse_unported(cfg)
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Engine(device='cuda') needs a CUDA device "
                               "and none is available; pass device='cpu' "
                               "to run on the host")
        self.printer = InfoPrinter(
            "NARUTO-TPU", cfg.general.num_iter,
            f"{cfg.general.dataset} - {cfg.general.scene}", quiet=quiet)
        self.timer = Timer()
        # the simulator must render exactly the mapper's sensor size
        ph = tuple(cfg.sim.pinhole_hw)
        cam_hw = (cfg.cam.H // cfg.cam.downsample,
                  cfg.cam.W // cfg.cam.downsample)
        if ph != cam_hw:
            raise ValueError(
                f"sim.pinhole_hw {ph} != cam (H/downsample, W/downsample) "
                f"{cam_hw}; set both config sections to the same sensor "
                f"size")
        self.sim = init_simulator(cfg, self.device, self.printer)
        self.mapper = Mapper(cfg, self.device, self.printer, self.timer)
        self.pose_loader = PoseLoader(cfg)

        self.run_dir = os.path.join(cfg.general.result_dir,
                                    cfg.general.dataset, cfg.general.scene)
        self.mapper.result_dir = self.run_dir
        # config provenance: the merged config next to the artifacts
        os.makedirs(self.run_dir, exist_ok=True)
        with open(os.path.join(self.run_dir, "config.json"), "w") as f:
            json.dump(cfg.to_dict(), f, indent=1, default=str)

    def run(self, num_iter: Optional[int] = None) -> np.ndarray:
        """Map the trajectory's first `num_iter` steps (general.num_iter by
        default); returns the last pose."""
        n = num_iter if num_iter is not None else self.cfg.general.num_iter
        c2w = self.pose_loader.load_init_pose()
        traj = self.pose_loader.traj
        # frame i+1's pose is known: a worker renders it while step i maps
        prefetcher = FramePrefetcher(self.sim, lambda s: traj[s],
                                     needs_fn=self.mapper.needs_frame,
                                     horizon=min(n, len(traj)))
        try:
            for i in range(n):
                # the prefetcher's worker steps the sim ahead of the engine
                self.mapper.update_step(i)
                c2w = self.pose_loader.update_pose(c2w, i)
                with self.timer.time("Simulation", "General"):
                    color, depth = prefetcher.get(i)
                with self.timer.time("SLAM", "General"):
                    self.mapper.online_recon_step(i, color, depth, c2w)
                if (i + 1) % 250 == 0:
                    print(f"[Engine] step {i + 1} timers:\n"
                          f"{self.timer.summary()}", flush=True)
        finally:
            prefetcher.close()
        return np.asarray(c2w)

    def finalize(self, result_dir: Optional[str] = None) -> None:
        cfg = self.cfg
        out = result_dir or self.run_dir
        os.makedirs(out, exist_ok=True)

        def section(name):
            return self.timer.time(name, "Finalize")

        mesh_path = os.path.join(
            out, f"mesh_{cfg.general.num_iter:04d}_final.ply")
        with section("final_mesh"):
            save_mesh(self.mapper, mesh_path, voxel_size=cfg.mesh.voxel_final)
        with section("checkpoint"):
            self.mapper.save_ckpt(os.path.join(
                out, f"ckpt_{cfg.general.num_iter:04d}_final.pkl"))

        results = os.path.join(out, "eval_result.txt")
        n = min(cfg.general.num_iter, self.mapper.poses.shape[0])
        traj_len = eval_traj_length(self.mapper.poses[:n].cpu().numpy())
        update_results_file({"traj_length_m": traj_len}, results)

        # the analytic scene's exact GT mesh: the recon metrics need no
        # external data
        vs = cfg.mesh.voxel_eval
        with section("gt_mesh"):
            gt_v, gt_f = marching_cubes(self.sim.gt_occupancy_volume(vs),
                                        truncation=1e9)
            gt_path = os.path.join(out, "gt_mesh.ply")
            write_ply(gt_path, gt_v * vs + cfg.mapper.bound_np[:, 0], gt_f)

        # the full metric row next to traj_length (ref eval_replica.sh +
        # update_results_file, src/utils/general_utils.py:163-188)
        # (the JAX package's finalize swallows a failed evaluation; here it
        # fails the run)
        if cfg.general.final_eval:
            rec_v, rec_f, _ = read_ply(mesh_path)
            gt_v, gt_f, _ = read_ply(gt_path)
            with section("eval_mesh"):
                row = eval_mesh(rec_v, rec_f, gt_v, gt_f)
            with section("eval_mad"):
                row["mad_cm"] = eval_mad(self.mapper, gt_v, gt_f)
            update_results_file(row, results)
            self.printer(
                "Eval: " + " ".join(f"{k}={v:.3f}" for k, v in row.items()),
                cfg.general.num_iter, "Eval")
        self.timer.time_analysis()
