"""The reconstruction engine: the sim -> map -> plan loop (counterpart of
naruto_tpu/system/engine.py).

Per step: update the module steps, resolve the pose (the planner's in the
active mode, the trajectory's in the passive one), take the RGB-D frame
when the mapper consumes it (``needs_frame``), run one mapping step, and
in the active mode let the planner emit the next pose from the volumes of
the last mapping step. The frame (timed as ``Simulation``) is rendered on
the main thread, but in a passive run from step 0 over a simulator that
makes its frames on the host (``host_frame``: raycast, replay): there
sim/prefetch.py's worker makes the next consumed frame and copies it to
the device while the mapper trains on the current one, and steps the
simulator itself. The analytic simulator renders on the card, so there is
no host-to-device hop to hide, and a worker thread issuing its render op
by op was measured to slow the run (300 passive steps: 13.20-15.13 s of
``run()`` against 11.29-12.13 s inline, +17%, on an NVIDIA H100 80GB HBM3
at a 700 W power limit; its Python held the GIL the host-bound BA needs):
it renders inline. At the end, ``finalize`` writes
the final mesh, the checkpoint, the trajectory length, the planner's
statistics (``planner_stats.json``, active mode), the ground truth and the
metric row (accuracy, completion, ratio, F-score, MAD) to
``eval_result.txt``, and prints the timing breakdown. The ground truth is,
in the JAX package's order, the analytic scene's exact mesh (a simulator
with ``gt_occupancy_volume``), else the ``sim.scene_path`` mesh (``.ply``,
``.glb``, ``.gltf``, or ``mesh.ply``/``mesh.glb`` in a scene directory);
without one there is no metric row. A failed evaluation fails the run.

With ``general.ckpt_freq`` > 0 every ckpt_freq-th step (but step 0) writes
``<result_dir>/<dataset>/<scene>/full_state_latest.pkl``: the mapper's
full state, the pose and the planner's state. ``run(resume_from=...)``
continues from such a snapshot (of either package) at its step + 1.

With ``vis.enable_all_vis`` the artifact saver (visualization/saver.py)
writes every step's artifacts under ``<run dir>/visualization/``. While it
saves or shows the rgbd panel, every frame renders (``vis_needs_rgbd``):
the saver gets the simulator's float colour, the mapper the uint8 frame on
the steps that consume one, as without the saver.

Under a process group of several ranks (``torchrun``, parallel/mesh.py)
every rank runs this same loop with the same seed, so every rank renders
the same frames and, the volumes being gathered, makes the same plans.
Rank 0 alone writes files (config.json, meshes, checkpoints, snapshots,
planner_stats.json, the saver's artifacts, eval_result.txt) and prints;
the other ranks render every frame rank 0's saver renders, and nothing
else. At the end of ``run`` the ranks compare checksums of their final
pose, poses and field, and the run raises where they differ.
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
from naruto_tpu_torch.mesh.ply import read_mesh, read_ply, write_ply
from naruto_tpu_torch.parallel.mesh import assert_replicated, current_mesh
from naruto_tpu_torch.planner import init_planner
from naruto_tpu_torch.sim import init_simulator
from naruto_tpu_torch.sim.base import quantize_color
from naruto_tpu_torch.sim.prefetch import FramePrefetcher
from naruto_tpu_torch.system.pose_loader import PoseLoader
from naruto_tpu_torch.utils.printer import InfoPrinter
from naruto_tpu_torch.utils.results import update_results_file
from naruto_tpu_torch.utils.timer import Timer


SNAPSHOT_NAME = "full_state_latest.pkl"


class Engine:
    def __init__(self, cfg: MainConfig, device="cuda", quiet: bool = False):
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Engine(device='cuda') needs a CUDA device "
                               "and none is available; pass device='cpu' "
                               "to run on the host")
        self.mesh = current_mesh(self.device)
        # the rank that writes and prints
        self.lead = self.mesh is None or self.mesh.rank == 0
        self.printer = InfoPrinter(
            "NARUTO-TPU", cfg.general.num_iter,
            f"{cfg.general.dataset} - {cfg.general.scene}",
            quiet=quiet or not self.lead)
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
        if cfg.enable_active_planning:
            self.planner = init_planner(cfg, self.device, self.printer,
                                        self.timer)
            self.planner.update_sim(self.sim)
            self.planner.init_data(cfg.mapper.bound_np)
            self.planner.init_local_planner()
            # the volumes of the last mapping step, which the planner reads
            self.uncert_sdf = None
        self.pose_loader = PoseLoader(cfg)

        self.run_dir = os.path.join(cfg.general.result_dir,
                                    cfg.general.dataset, cfg.general.scene)
        self.visualizer = None
        if not self.lead:
            return
        self.mapper.result_dir = self.run_dir
        # config provenance: the merged config next to the artifacts
        os.makedirs(self.run_dir, exist_ok=True)
        with open(os.path.join(self.run_dir, "config.json"), "w") as f:
            json.dump(cfg.to_dict(), f, indent=1, default=str)
        if cfg.vis.enable_all_vis:
            from naruto_tpu_torch.visualization.saver import ArtifactSaver

            self.visualizer = ArtifactSaver(cfg, self.printer)

    def _init_pose(self) -> np.ndarray:
        c2w = self.pose_loader.load_init_pose()
        if self.cfg.enable_active_planning and self.pose_loader.traj is None \
                and self.cfg.start_c2w is None:
            # no per-scene start configured: asset-free runs start at the
            # room center (always free space in the analytic scenes)
            c2w = np.eye(4, dtype=np.float32)
            c2w[:3, 3] = self.cfg.mapper.bound_np.mean(axis=1)
        return c2w

    def _generators(self) -> dict:
        """The draw sites outside the mapper whose states ride a snapshot."""
        if self.cfg.enable_active_planning:
            return self.planner.generators()
        return {}

    def snapshot_path(self) -> str:
        return os.path.join(self.run_dir, SNAPSHOT_NAME)

    def save_snapshot(self, c2w) -> None:
        """The full state at the current step, with the pose the next step
        starts from and the planner's state."""
        extra = {"c2w": np.asarray(c2w, np.float32).tolist()}
        if self.cfg.enable_active_planning:
            extra["planner"] = self.planner.export_state()
        with self.timer.time("full_state_save", "General"):
            self.mapper.save_full_state(self.snapshot_path(), extra=extra,
                                        generators=self._generators())

    def resume(self, path: str, c2w: np.ndarray) -> np.ndarray:
        """Restore a snapshot; returns the pose to continue from."""
        with self.timer.time("full_state_load", "General"):
            extra = self.mapper.load_full_state(
                path, generators=self._generators())
        if extra.get("c2w") is not None:
            c2w = np.asarray(extra["c2w"], np.float32)
        if self.cfg.enable_active_planning:
            if extra.get("planner"):
                self.planner.restore_state(extra["planner"])
            # the restored FSM may be mid-plan, and its collision checks
            # read the volumes before the next mapping step: recompute them
            # from the restored field (a pure function of it)
            self.uncert_sdf = self.mapper.get_map_volumes_lazy()
        self.printer(f"Resumed from {path} at step {self.mapper.step + 1}",
                     self.mapper.step + 1, "Engine")
        return c2w

    def _prefetcher(self, n: int, start: int,
                    vis_needs_rgbd: bool) -> Optional[FramePrefetcher]:
        """The frame prefetcher of a passive run from step 0 over a
        simulator that makes its frames on the host, else None (the JAX
        engine's rule, for host frame sources)."""
        traj = self.pose_loader.traj
        if (self.cfg.enable_active_planning or not traj or start != 0
                or not hasattr(self.sim, "host_frame")):
            return None
        return FramePrefetcher(
            self.sim, lambda s: traj[s],
            needs_fn=None if vis_needs_rgbd else self.mapper.needs_frame,
            horizon=min(n, len(traj)))

    def run(self, num_iter: Optional[int] = None,
            resume_from: Optional[str] = None) -> np.ndarray:
        """Steps up to `num_iter` (general.num_iter by default), from step 0
        or, with `resume_from` (a full-state snapshot), from its step + 1
        at its pose; returns the last pose (host [4, 4]). A resumed run
        draws as the unbroken one would (the generators ride the
        snapshot), but for the RRT's host rng, which is not restored: the
        two part at the next plan."""
        cfg = self.cfg
        n = num_iter if num_iter is not None else cfg.general.num_iter
        c2w = self._init_pose()
        start = 0
        if resume_from:
            c2w = self.resume(resume_from, c2w)
            start = self.mapper.step + 1
        # the rgbd panel consumes every frame (on every rank, so that all
        # render alike)
        vis_needs_rgbd = cfg.vis.enable_all_vis and (cfg.vis.save_rgbd
                                                     or cfg.vis.vis_rgbd)
        prefetcher = self._prefetcher(n, start, vis_needs_rgbd)
        try:
            c2w = self._loop(c2w, start, n, vis_needs_rgbd, prefetcher)
        finally:
            if prefetcher is not None:
                prefetcher.close()
        if self.mesh is not None:
            m = self.mapper
            assert_replicated(
                self.mesh, [torch.from_numpy(np.asarray(c2w, np.float32)),
                            m.poses, *m._all_params()],
                "the final pose, poses and field")
        return np.asarray(c2w)

    def _loop(self, c2w, start: int, n: int, vis_needs_rgbd: bool,
              prefetcher: Optional[FramePrefetcher]):
        cfg = self.cfg
        active = cfg.enable_active_planning
        vis = self.visualizer
        # with a prefetcher its worker steps the simulator, ahead of this
        # loop: stepping it here too would move the frame in the making
        stepped = ((self.mapper,) if prefetcher is not None
                   else (self.sim, self.mapper)) \
            + ((self.planner,) if active else ())
        for i in range(start, n):
            for mod in stepped:
                mod.update_step(i)
            if vis is not None:
                vis.update_step(i)
            c2w = self.pose_loader.update_pose(c2w, i)
            color = depth = vis_color = vis_depth = None
            # a frame nothing consumes is not made, and not timed
            needs = self.mapper.needs_frame(i)
            if vis_needs_rgbd:
                with self.timer.time("Simulation", "General"):
                    vis_color, vis_depth = (
                        prefetcher.get(i) if prefetcher is not None
                        else self.sim.simulate(c2w)[:2])
                    if needs:
                        color, depth = quantize_color(vis_color), vis_depth
            elif needs:
                with self.timer.time("Simulation", "General"):
                    color, depth = (prefetcher.get(i) if prefetcher is not None
                                    else self.sim.frame(c2w))
            with self.timer.time("SLAM", "General"):
                new_vols = self.mapper.online_recon_step(i, color, depth,
                                                         c2w)
            if vis is not None:
                with self.timer.time("Visualization", "General"):
                    vis.main(self.mapper, self.planner if active else None,
                             vis_color, vis_depth, c2w)
            if active:
                with self.timer.time("Planning", "General"):
                    if new_vols is not None:
                        self.uncert_sdf = new_vols
                    c2w = self.planner.main(self.uncert_sdf, c2w,
                                            new_vols is not None)
            freq = cfg.general.ckpt_freq
            if freq and i > 0 and i % freq == 0 and self.lead:
                self.save_snapshot(c2w)
            if (i + 1) % 250 == 0 and self.lead:
                print(f"[Engine] step {i + 1} timers:\n"
                      f"{self.timer.summary()}", flush=True)
                if active:
                    print(f"[Engine] planner: "
                          f"{self.planner.stats_summary()}", flush=True)
        return c2w

    def finalize(self, result_dir: Optional[str] = None) -> None:
        """Rank 0's; the other ranks have nothing to write."""
        if not self.lead:
            return
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

        # exploration diagnostics
        if cfg.enable_active_planning:
            with open(os.path.join(out, "planner_stats.json"), "w") as f:
                json.dump({"summary": self.planner.stats_summary(),
                           "events": self.planner.stats["events"]}, f,
                          indent=1)

        with section("gt_mesh"):
            gt_path = self._ground_truth(out)

        # the full metric row next to traj_length (ref eval_replica.sh +
        # update_results_file, src/utils/general_utils.py:163-188)
        # (the JAX package's finalize swallows a failed evaluation; here it
        # fails the run)
        if cfg.general.final_eval and gt_path is not None:
            self.printer(f"Eval against the ground truth {gt_path}",
                         cfg.general.num_iter, "Eval")
            rec_v, rec_f, _ = read_ply(mesh_path)
            gt_v, gt_f, _ = read_mesh(gt_path)
            with section("eval_mesh"):
                row = eval_mesh(rec_v, rec_f, gt_v, gt_f)
            with section("eval_mad"):
                row["mad_cm"] = eval_mad(self.mapper, gt_v, gt_f)
            update_results_file(row, results)
            self.printer(
                "Eval: " + " ".join(f"{k}={v:.3f}" for k, v in row.items()),
                cfg.general.num_iter, "Eval")
        self.timer.time_analysis()

    def _ground_truth(self, out: str) -> Optional[str]:
        """The ground-truth mesh's path, in the JAX package's order: the
        analytic scene's exact mesh (written to out/gt_mesh.ply), else the
        scene_path mesh, else mesh.ply / mesh.glb in the scene directory;
        None without one."""
        cfg = self.cfg
        if hasattr(self.sim, "gt_occupancy_volume"):
            vs = cfg.mesh.voxel_eval
            gt_v, gt_f = marching_cubes(self.sim.gt_occupancy_volume(vs),
                                        truncation=1e9)
            gt_path = os.path.join(out, "gt_mesh.ply")
            write_ply(gt_path, gt_v * vs + cfg.mapper.bound_np[:, 0], gt_f)
            return gt_path
        scene = cfg.sim.scene_path
        if scene.lower().endswith((".ply", ".glb", ".gltf")) \
                and os.path.exists(scene):
            return scene
        for name in ("mesh.ply", "mesh.glb"):
            cand = os.path.join(scene, name)
            if os.path.isfile(cand):
                return cand
        return None
