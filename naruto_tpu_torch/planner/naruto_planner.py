"""The NARUTO active planner: a 7-state FSM over uncertainty-guided goals
(counterpart of naruto_tpu/planner/naruto_planner.py).

Behavioral contract from src/planner/naruto_planner.py (C17 in SURVEY.md):
  states: staying -> planning -> rotationPlanningAtStart -> rotatingAtStart
          -> movingToGoal -> rotationPlanningAtGoal -> rotatingAtGoal ->
          planning; collision or unreachable goal -> staying.
Per planning round: filter the uncertainty volume by the traversability mask,
aggregate uncertainty over the goal space (aggregation.py), pick the argmax
goal and its top-obs_per_goal look-at targets, plan a path with RRT
(rrt.py); if aggregation found no valid pairs, compute a fresh
traversability mask (dense RRT growth) and retry; if the RRT fails twice,
derive the traversability mask from tree reachability so the next round
avoids unreachable goals (ref :403-460). While moving, each step pops one
path node, orients the camera at the current look-at target, and runs
collision detection (SDF line check + simulated ERP distance, combination
depending on dataset — ref :512-594).

Where it runs: the volumes arrive as the mapper's LazyVolumes view of its
device tensors (or as a plain pair of tensors). The aggregation runs on the
device; the RRT, the rotations and the FSM run on the host in numpy. The
SDF volume is copied to the host only by the states that read it
(planning: RRT and traversability mask, except at step 0, whose plan takes
the SDF as all free; movingToGoal: the collision line check), once per
volume, through the view, timed as the [Mapper] ``volumes_wait`` section;
the rotating states never touch the device. The filtered uncertainty is a
new tensor: the mapper's own volume, which its active-ray selection reads,
is never written.

Draws: the RRT's from a numpy Generator seeded with general.seed, as in the
JAX package (the same SDF volumes grow the same trees); the aggregation's
target subset from the "planner_subset" torch.Generator of
utils/seeding.py, through ``_draw_subset`` (tests replace it with the JAX
package's draws).

``export_state``/``restore_state`` carry the FSM and the goal-repeat
counters through a full-state snapshot, under the JAX package's JSON keys
but its ``agg_key``: the subset draw's generator rides the snapshot's
generator states (``generators()``). The RRT's numpy rng is not restored,
as in the JAX package: a resumed run's trees diverge from the unbroken
run's at the next plan.
"""
from __future__ import annotations

import contextlib
import time
from collections import Counter
from typing import Dict, List, Optional

import numpy as np
import torch

from naruto_tpu_torch.config.schema import MainConfig
from naruto_tpu_torch.geometry.pose import lookat_rotation
from naruto_tpu_torch.geometry.voxel import loc2vox, volume_shape, vox2loc
from naruto_tpu_torch.mapping.mapper import LazyVolumes
from naruto_tpu_torch.planner.aggregation import (AggregationOutputs,
                                                  Aggregator, make_goal_space)
from naruto_tpu_torch.planner.collision import is_collision_free
from naruto_tpu_torch.planner.rotation import rotation_planning
from naruto_tpu_torch.planner.rrt import RRTPlanner
from naruto_tpu_torch.sim.base import to_host
from naruto_tpu_torch.utils.printer import InfoPrinter
from naruto_tpu_torch.utils.seeding import make_generator
from naruto_tpu_torch.utils.timer import Timer


class NarutoPlanner:
    def __init__(self, cfg: MainConfig, device="cuda",
                 printer: Optional[InfoPrinter] = None,
                 timer: Optional[Timer] = None):
        self.cfg = cfg
        self.pcfg = cfg.planner
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("NarutoPlanner(device='cuda') needs a CUDA "
                               "device and none is available")
        self.printer = printer or InfoPrinter(quiet=True)
        # the engine's timer (volumes_wait, path_planning) or an own one
        self.timer = timer or Timer()
        self.step = 0
        self.state = "staying"
        self.sim = None
        self.path: List[np.ndarray] = []
        self.lookat_tgts: List[np.ndarray] = []
        self.rots: List[np.ndarray] = []
        self.is_goal_reachable = False
        self.rng = np.random.default_rng(cfg.general.seed)
        self.subset_gen = make_generator(cfg.general.seed, "planner_subset",
                                         self.device)
        # exploration diagnostics: per-plan events + per-step state dwell,
        # dumped by Engine.finalize as planner_stats.json and summarized by
        # stats_summary()
        self.stats: Dict = {"events": [], "state_steps": {},
                            "collisions": 0, "mask_refilters": 0,
                            "mask_decays": 0}
        self._goal_visits: Dict = {}    # goal-space index -> times chosen
        self._last_goal_gi = None       # goal-space index of current plan
        # the view over plain (uncert, sdf) tensors handed in, if any
        self._lazy: Optional[LazyVolumes] = None

    # -------------------------------------------------------------- wiring
    def update_step(self, step: int) -> None:
        self.step = step

    # ---------------------------------------------------- state for resume
    def export_state(self) -> Dict:
        """The goal-repeat counters and the FSM as JSON (the JAX package's
        keys, without agg_key)."""
        return {"goal_visits": {",".join(str(int(i)) for i in k): int(v)
                                for k, v in self._goal_visits.items()},
                "last_goal_gi": (None if self._last_goal_gi is None
                                 else [int(i) for i in self._last_goal_gi]),
                "fsm": {
                    "state": self.state,
                    "path": [[float(v) for v in np.asarray(p)]
                             for p in self.path],
                    "lookat_tgts": [[float(v) for v in np.asarray(t)]
                                    for t in self.lookat_tgts],
                    "rots": [np.asarray(r).reshape(-1).tolist()
                             for r in self.rots],
                    "is_goal_reachable": bool(self.is_goal_reachable),
                }}

    def restore_state(self, blob: Dict) -> None:
        """export_state's JSON (or the JAX package's: its agg_key, a
        threefry key, is ignored). The path and the look-at targets come
        back as float64 and the rotations as float32, the dtypes the live
        FSM holds (the JAX package makes all three float32), so a resumed
        run moves exactly as the unbroken one."""
        self._goal_visits = {
            tuple(int(i) for i in k.split(",")): int(v)
            for k, v in blob.get("goal_visits", {}).items()}
        gi = blob.get("last_goal_gi")
        self._last_goal_gi = None if gi is None else tuple(
            int(i) for i in gi)
        fsm = blob.get("fsm")
        if fsm:
            self.state = fsm["state"]
            self.path = [np.asarray(p, np.float64) for p in fsm["path"]]
            self.lookat_tgts = [np.asarray(t, np.float64)
                                for t in fsm["lookat_tgts"]]
            self.rots = [np.asarray(r, np.float32).reshape(3, 3)
                         for r in fsm["rots"]]
            self.is_goal_reachable = bool(fsm["is_goal_reachable"])

    def generators(self) -> Dict[str, torch.Generator]:
        """The planner's draw sites, for a snapshot's generator states."""
        return {"planner.planner_subset": self.subset_gen}

    def update_sim(self, sim) -> None:
        self.sim = sim

    def init_data(self, bound) -> None:
        self.bbox = np.asarray(bound, dtype=np.float32)
        # single source of truth: the planner volume IS the mapper's
        # uncertainty/SDF volume (ref configs/default.py:100 ties them)
        self.voxel_size = self.cfg.mapper.voxel_size
        self.vol_shape = volume_shape(self.bbox, self.voxel_size)
        self.goal_space = make_goal_space(self.vol_shape, self.voxel_size,
                                          self.pcfg.gs_z_levels)
        self.aggregate = Aggregator(
            self.vol_shape, self.goal_space, self.voxel_size,
            top_k=self.pcfg.uncert_top_k,
            subset=self.pcfg.uncert_top_k_subset,
            sensing_range=tuple(self.pcfg.gs_sensing_range),
            safe_sdf=self.pcfg.safe_sdf,
            subset_nonzero_weighted=self.pcfg.subset_nonzero_weighted,
            device=self.device)
        self.traversability_mask = np.ones(self.vol_shape, dtype=np.float32)

    def init_local_planner(self) -> None:
        self.local_planner = RRTPlanner(
            vol_shape=self.vol_shape,
            max_iter=self.pcfg.rrt_max_iter,
            step_size=self.pcfg.rrt_step_size,
            maxz=self.pcfg.rrt_maxz,
            z_levels=self.pcfg.rrt_z_levels,
            step_amplifier=self.pcfg.rrt_step_amplifier,
            collision_thre=self.pcfg.collision_thre,
            enable_direct_line=self.pcfg.enable_direct_line,
            rng=self.rng)

    def vox2loc(self, vox):
        return vox2loc(vox, self.bbox, self.voxel_size)

    def loc2vox(self, loc):
        return loc2vox(loc, self.bbox, self.voxel_size)

    def _host_sdf(self, vols) -> np.ndarray:
        """The SDF volume on the host, copied once per volume through its
        LazyVolumes view (made here for a plain pair of tensors)."""
        if not isinstance(vols, LazyVolumes):
            if self._lazy is None or self._lazy[1] is not vols[1]:
                self._lazy = LazyVolumes(vols[0], vols[1], self.timer)
            vols = self._lazy
        return vols.host(1)

    # ----------------------------------------------------------------- API
    def main(self, uncert_sdf_vols, cur_pose: np.ndarray,
             is_new_vols: bool) -> np.ndarray:
        """uncert_sdf_vols: the (uncert_vol, sdf_vol) [X, Y, Z] device
        tensors, as the mapper's LazyVolumes or a plain pair;
        cur_pose: the host [4, 4] c2w; returns the next pose (host)."""
        self.update_state(uncert_sdf_vols, cur_pose, is_new_vols)
        self.printer(f"Current state: {self.state}", self.step, "Planner")
        ss = self.stats["state_steps"]
        ss[self.state] = ss.get(self.state, 0) + 1
        return self.compute_next_state_pose(cur_pose, uncert_sdf_vols)

    # --------------------------------------------------------- state update
    def update_state(self, uncert_sdf_vols, cur_pose, is_new_vols) -> None:
        # only movingToGoal reads the volumes here
        s = self.state
        if s == "planning":
            self.state = ("rotationPlanningAtStart" if self.is_goal_reachable
                          else "staying")
        elif s == "rotationPlanningAtStart":
            self.state = "rotatingAtStart"
        elif s == "rotatingAtStart":
            self.state = "movingToGoal" if not self.rots else "rotatingAtStart"
        elif s == "movingToGoal":
            if not self.path:
                self.state = "rotationPlanningAtGoal"
            else:
                next_loc = self.vox2loc(self.path[-1])
                if self.detect_collision(self._host_sdf(uncert_sdf_vols),
                                         cur_pose, next_loc):
                    self.state = "staying"
                    self.stats["collisions"] += 1
                    if (self.pcfg.goal_repeat_penalty > 0.0
                            and self._last_goal_gi is not None):
                        # a collision is a FAILED attempt at this goal:
                        # charge it a visit so the repeat penalty accrues
                        # per attempt, not per choice
                        self._goal_visits[self._last_goal_gi] = \
                            self._goal_visits.get(self._last_goal_gi, 0) + 1
        elif s == "rotationPlanningAtGoal":
            self.state = "rotatingAtGoal"
        elif s == "rotatingAtGoal":
            self.state = "planning" if not self.rots else "rotatingAtGoal"
        elif s == "staying":
            self.state = "planning" if is_new_vols else "staying"

    # ------------------------------------------------------- pose computing
    def compute_next_state_pose(self, cur_pose, uncert_sdf_vols) -> np.ndarray:
        s = self.state
        if s == "planning":
            t0 = time.time()
            out = self.uncertainty_aware_planning(uncert_sdf_vols, cur_pose)
            self.stats["plan_wall_s"] = (self.stats.get("plan_wall_s", 0.0)
                                         + time.time() - t0)
            self.is_goal_reachable = out["is_goal_reachable"]
            self.lookat_tgts = out["lookat_tgts"]
            self.path = out["path"]
            return cur_pose.copy()
        if s == "rotationPlanningAtStart":
            self.rots = self._plan_rotations(cur_pose, [self.lookat_tgts[0]])
            return cur_pose.copy()
        if s in ("rotatingAtStart", "rotatingAtGoal"):
            rot = self.rots.pop(0)
            new_pose = cur_pose.copy()
            new_pose[:3, :3] = rot
            return new_pose
        if s == "movingToGoal":
            node = self.path.pop()
            next_loc = self.vox2loc(node)
            rot = lookat_rotation(next_loc, self.lookat_tgts[0],
                                  np.asarray(self.pcfg.up_dir))
            new_pose = cur_pose.copy()
            new_pose[:3, :3] = rot
            new_pose[:3, 3] = next_loc
            return new_pose
        if s == "rotationPlanningAtGoal":
            self.rots = self._plan_rotations(cur_pose, self.lookat_tgts)
            return cur_pose.copy()
        if s == "staying":
            return cur_pose.copy()
        raise NotImplementedError(s)

    def _plan_rotations(self, cur_pose, lookat_locs) -> List[np.ndarray]:
        rots = [lookat_rotation(cur_pose[:3, 3], loc,
                                np.asarray(self.pcfg.up_dir))
                for loc in lookat_locs]
        return rotation_planning(cur_pose[:3, :3], rots,
                                 self.pcfg.max_rot_deg)

    # ------------------------------------------------------------- planning
    def uncertainty_aware_planning(self, uncert_sdf_vols, cur_pose) -> Dict:
        uncert_vol, sdf_vol = uncert_sdf_vols
        if self.step == 0:
            self.traversability_mask = np.ones(self.vol_shape,
                                               dtype=np.float32)
        decay = self.pcfg.trav_mask_decay
        if (decay > 0 and self.stats["events"]
                and len(self.stats["events"]) % decay == 0):
            # mitigation (schema: PlannerConfig.trav_mask_decay): retry
            # stale masked-out regions against the improved map
            self.stats["mask_decays"] = self.stats.get("mask_decays", 0) + 1
            self.traversability_mask = np.ones(self.vol_shape,
                                               dtype=np.float32)
        if self.pcfg.enable_uncert_filtering:
            uncert_vol = uncert_vol * self._mask_on_device()

        valid, agg = self._aggregate(uncert_vol, sdf_vol)
        if not valid and self.pcfg.enable_uncert_filtering:
            self.printer("No valid goals; computing traversability mask",
                         self.step, "Planner")
            self.stats["mask_refilters"] += 1
            self.traversability_mask = self.compute_traversability_mask(
                self._host_sdf(uncert_sdf_vols), cur_pose)
            uncert_vol = uncert_vol * self._mask_on_device()
            valid, agg = self._aggregate(uncert_vol, sdf_vol)

        goal_vxl, lookat_tgts = self.goal_search(agg)
        self.stats["events"].append({
            "step": int(self.step),
            "uncert_mass": float(uncert_vol.sum()),
            "goal_vxl": [int(v) for v in goal_vxl],
            "pos_vxl": [int(v) for v in self.loc2vox(cur_pose[:3, 3])],
        })

        # at step 0 the map is unknown and path_planning takes it as free
        sdf_host = (None if self.step == 0
                    else self._host_sdf(uncert_sdf_vols))
        if self.pcfg.enable_eval:
            self.timer.start("path_planning", "Planner")
        path, reachable, trav_mask = self.path_planning(sdf_host, cur_pose,
                                                        goal_vxl)
        if self.pcfg.enable_eval:
            self.timer.end("path_planning")
            self.local_planner.update_eval(
                reachable, self.timer.get_last_timing("path_planning"), path)
            self.local_planner.print_eval_result(self.printer)
        if trav_mask is not None:
            self.traversability_mask = trav_mask
        ev = self.stats["events"][-1]
        ev["reachable"] = bool(reachable)
        ev["path_len"] = len(path)
        return {"path": path, "is_goal_reachable": reachable,
                "lookat_tgts": lookat_tgts}

    def _mask_on_device(self) -> torch.Tensor:
        return torch.from_numpy(self.traversability_mask).to(self.device)

    def stats_summary(self) -> Dict:
        """Aggregate the exploration diagnostics: dwell per state, plan
        count, unreachable-goal count, goal-repeat concentration, and the
        uncertainty-mass trajectory (first/min/last)."""
        ev = self.stats["events"]
        goals = [tuple(e["goal_vxl"]) for e in ev]
        rep = Counter(goals).most_common(1)
        masses = [e["uncert_mass"] for e in ev]
        return {
            "n_plans": len(ev),
            "n_unreachable": sum(1 for e in ev
                                 if not e.get("reachable", True)),
            "goal_repeat_max": (rep[0][1] if rep else 0),
            "goal_repeat_vxl": (list(rep[0][0]) if rep else None),
            "collisions": self.stats["collisions"],
            "collision_overrides": self.stats.get("collision_overrides", 0),
            "mask_refilters": self.stats["mask_refilters"],
            "mask_decays": self.stats.get("mask_decays", 0),
            "state_steps": dict(self.stats["state_steps"]),
            "uncert_mass_first": masses[0] if masses else None,
            "uncert_mass_min": min(masses) if masses else None,
            "uncert_mass_last": masses[-1] if masses else None,
            # host wall-clock decomposition: sim probes apart from
            # goal-search + RRT planning
            "plan_wall_s": round(self.stats.get("plan_wall_s", 0.0), 1),
            "probe_wall_s": round(self.stats.get("probe_wall_s", 0.0), 1),
            "n_probes": self.stats.get("n_probes", 0),
        }

    def _draw_subset(self, top_vals: torch.Tensor) -> torch.Tensor:
        return self.aggregate.draw_subset(top_vals, self.subset_gen)

    def _aggregate(self, uncert_vol, sdf_vol):
        agg = self.aggregate(uncert_vol, sdf_vol, self._draw_subset)
        valid = bool(agg.any_valid) or self.pcfg.force_uncert_aggre
        if not valid:
            self.printer("Warning: no valid (goal, target) pairs",
                         self.step, "Planner")
        return valid, agg

    def goal_search(self, agg: AggregationOutputs):
        """Argmax goal + top-k uncertain visible targets from it
        (ref goal_search_v2, naruto_planner.py:462-510)."""
        gs_aggre = to_host(agg.gs_aggre)

        pen = self.pcfg.goal_repeat_penalty
        if pen > 0.0 and self._goal_visits:
            # mitigation (schema: PlannerConfig.goal_repeat_penalty):
            # discount goals already chosen so unresolvable uncertainty
            # can't monopolize the plan budget
            gs_aggre = gs_aggre.copy()
            for gi_v, n in self._goal_visits.items():
                gs_aggre[gi_v] /= 1.0 + pen * n

        flat_idx = int(gs_aggre.argmax())
        gi = np.unravel_index(flat_idx, gs_aggre.shape)
        self._last_goal_gi = gi
        if pen > 0.0:
            self._goal_visits[gi] = self._goal_visits.get(gi, 0) + 1
        goal_vxl = np.array([self.goal_space.x_range[gi[0]],
                             self.goal_space.y_range[gi[1]],
                             self.goal_space.z_range[gi[2]]], dtype=np.float64)

        # only the chosen goal's row of the [G, K] collections leaves the
        # device
        per_goal = to_host(agg.collections[flat_idx])
        topk_vxl = to_host(agg.topk_vxl)
        k = min(self.pcfg.obs_per_goal, per_goal.shape[0])
        order = np.argsort(-per_goal)[:k]
        n_pos = max(int((per_goal[order] > 0).sum()), 1)
        order = order[:n_pos]
        lookat_tgts = [self.vox2loc(topk_vxl[j].astype(np.float64))
                       for j in order]
        return goal_vxl, lookat_tgts

    def path_planning(self, sdf_vol: Optional[np.ndarray], cur_pose,
                      goal_vxl):
        """RRT with one retry and reachability-mask fallback
        (ref path_planning_v2, naruto_planner.py:403-460). At step 0 the
        initial map is unknown: the SDF is all 100s (sdf_vol unused)."""
        if self.step == 0:
            sdf_vol = np.full(self.vol_shape, 100.0, dtype=np.float32)
        cur_vxl = self.loc2vox(cur_pose[:3, 3])
        self.local_planner.start_new_plan(cur_vxl, goal_vxl, sdf_vol)
        reachable = self.local_planner.run()
        trav_mask = None
        if not reachable:
            self.printer("RRT retry (densify)", self.step, "Planner")
            reachable = self.local_planner.run()
            if not reachable:
                self.printer("Updating traversability mask from RRT tree",
                             self.step, "Planner")
                trav_mask = self.local_planner.get_reachable_mask()
        path = self.local_planner.find_path()
        return path, reachable, trav_mask

    def compute_traversability_mask(self, sdf: np.ndarray,
                                    pose) -> np.ndarray:
        cur_vxl = self.loc2vox(pose[:3, 3])
        self.local_planner.start_new_plan(cur_vxl, np.zeros(3), sdf)
        self.local_planner.run_full()
        return self.local_planner.get_reachable_mask()

    # ------------------------------------------------------------ collision
    def _probe(self, cur_pose, next_pt_loc):
        """(closest ERP distance, invalid share) at the next pose."""
        next_pose = cur_pose.copy()
        next_pose[:3, 3] = next_pt_loc
        t0 = time.time()
        erp_dist = to_host(self.sim.probe_erp_dist(next_pose))
        self.stats["probe_wall_s"] = (
            self.stats.get("probe_wall_s", 0.0) + time.time() - t0)
        self.stats["n_probes"] = self.stats.get("n_probes", 0) + 1
        return float(erp_dist.min()), float((erp_dist > 1e6).mean())

    def detect_collision(self, sdf_vol: np.ndarray, cur_pose,
                         next_pt_loc) -> bool:
        """SDF line check + simulated ERP probes (ref detect_collision_v2,
        naruto_planner.py:512-594; combination depends on dataset).
        sdf_vol: the host SDF volume."""
        dataset = self.cfg.general.dataset
        dist_closest, invalid_ratio = np.inf, 0.0
        if self.sim is not None and dataset in ("MP3D", "NARUTO"):
            dist_closest, invalid_ratio = self._probe(cur_pose, next_pt_loc)

        cur_vxl = self.loc2vox(cur_pose[:3, 3])
        next_vxl = self.loc2vox(next_pt_loc)
        _, sdf_free = is_collision_free(next_vxl, cur_vxl, sdf_vol,
                                        step_size=self.pcfg.rrt_step_size)

        thre = self.pcfg.invalid_region_ratio_thre
        if dataset == "Replica":
            detected = not sdf_free
        elif dataset == "MP3D":
            detected = invalid_ratio > thre or not sdf_free
        elif dataset == "NARUTO":
            detected = (dist_closest < self.pcfg.collision_dist_thre
                        or invalid_ratio > thre or not sdf_free)
        else:
            detected = not sdf_free

        override = self.pcfg.collision_sim_override
        if detected and override > 0.0 and self.sim is not None:
            # mitigation (schema: PlannerConfig.collision_sim_override):
            # the learned SDF cannot trap the agent in real free space —
            # probe the simulator at the next pose (lazily; the MP3D/NARUTO
            # combinations probed above) and override the SDF verdict when
            # the world shows clearance.
            if np.isinf(dist_closest):
                dist_closest, invalid_ratio = self._probe(cur_pose,
                                                          next_pt_loc)
            if dist_closest >= override and invalid_ratio <= thre:
                self.stats["collision_overrides"] = \
                    self.stats.get("collision_overrides", 0) + 1
                self.printer(
                    f"Collision OVERRIDDEN by sim probe (clearance="
                    f"{dist_closest * 100:.1f}cm, invalid_ratio="
                    f"{invalid_ratio:.3f})", self.step, "Planner")
                return False
        if detected:
            # only report probe values that were actually measured
            probe = (f"dist_closest={dist_closest:.3f}, "
                     f"invalid_ratio={invalid_ratio:.3f}"
                     if np.isfinite(dist_closest) else "sim unprobed")
            self.printer(
                f"Collision detected (sdf_free={sdf_free}, {probe})",
                self.step, "Planner")
        return detected
