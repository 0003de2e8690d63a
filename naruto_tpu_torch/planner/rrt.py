"""RRT path planning over the SDF voxel volume (the port's own copy of
naruto_tpu/planner/rrt.py; the tree stays on the host, and with the same
rng and SDF volume it grows the same tree as the JAX package's).

Host-side redesign of src/planner/rrt.py + rrt_naruto.py. The tree is
inherently sequential/dynamic, so it stays on the host — but every inner
primitive that the reference ran per-point in Python (trilinear SDF lookups,
nearest-node search, reachability masks) is vectorized numpy / KD-tree here.

Semantics preserved (RRTNaruto variant, the shipped default —
configs/default.py:106):
  * `run`: alternate a greedy straight-line extension toward the goal
    (adding every collision-free step point, rrt_naruto.py:92-133) with an
    amplified random extension (step_size * step_amplifier, adding all
    consecutive collision-free step points, rrt_naruto.py:135-187); early
    exit when any new node is within step_size of the goal; on exit the
    goal's parent is the nearest node and reachability is whether that node
    is within step_size (rrt_naruto.py:219-234).
  * `run_full`: dense random growth (full volume range) for traversability
    estimation (rrt.py:350-355). The reference iterates max_iter = the full
    voxel count with Python interpolation (minutes); here growth stops after
    `full_iters` amplified extensions, which saturates coverage.
  * `get_reachable_mask`: voxel reachable iff within step_size of some tree
    node (rrt.py:389-431) — computed with a KD-tree instead of an
    all-pairs distance matrix.
  * `find_path`: backtrack goal -> start via parent links; the path list is
    ordered [goal, ..., first-step-from-start] and consumed from the tail.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
from scipy.spatial import cKDTree

from naruto_tpu_torch.planner.collision import is_collision_free


class RRTPlanner:
    def __init__(self,
                 vol_shape: Tuple[int, int, int],
                 max_iter: Optional[int] = None,
                 step_size: float = 1.0,
                 maxz: Optional[int] = None,
                 z_levels: Optional[List[int]] = None,
                 step_amplifier: int = 10,
                 collision_thre: float = 0.5,
                 margin: int = 0,
                 enable_direct_line: bool = True,
                 full_iters: Optional[int] = None,
                 rng: Optional[np.random.Generator] = None):
        self.vol_shape = tuple(vol_shape)
        self.step_size = float(step_size)
        self.step_amplifier = step_amplifier
        self.collision_thre = collision_thre
        self.enable_direct_line = enable_direct_line
        # the reference grows run_full for the full voxel count (rrt.py:350);
        # amplified extensions saturate coverage well before that, so cap it
        self.full_iters = (full_iters if full_iters is not None
                           else min(int(np.prod(vol_shape)), 20000))
        self.max_iter = (max_iter if max_iter is not None
                         else int(np.prod(vol_shape)))
        self.rng = rng or np.random.default_rng()

        X, Y, Z = vol_shape
        self.x_range = (margin, X - 1 - margin)
        self.y_range = (margin, Y - 1 - margin)
        if z_levels is not None:
            self.z_range = (z_levels[0], z_levels[1])
        else:
            zmax = Z - 1 - margin if maxz is None else min(Z - 1 - margin, maxz)
            self.z_range = (margin, zmax)
        self.full_ranges = ((0, X - 1), (0, Y - 1), (0, Z - 1))

        self.eval_results = {"time_ms": [], "node_num": [], "rrt_iter": []}
        self._reset(np.zeros(3), np.zeros(3), np.zeros(vol_shape))

    # ------------------------------------------------------------ lifecycle
    def _reset(self, start, goal, sdf_map):
        cap = 4096
        self.nodes = np.zeros((cap, 3), dtype=np.float64)
        self.parents = np.full((cap,), -1, dtype=np.int64)
        self.n_nodes = 1
        self.nodes[0] = start
        self.goal = np.asarray(goal, dtype=np.float64)
        self.goal_parent = -1
        self.sdf_map = sdf_map
        self.rrt_iter = 0

    def start_new_plan(self, start: np.ndarray, goal: np.ndarray,
                       sdf_map: np.ndarray) -> None:
        self._reset(np.asarray(start, dtype=np.float64),
                    np.asarray(goal, dtype=np.float64),
                    np.asarray(sdf_map))

    def _grow_capacity(self, need: int):
        while self.nodes.shape[0] < need:
            self.nodes = np.concatenate([self.nodes, np.zeros_like(self.nodes)])
            self.parents = np.concatenate(
                [self.parents, np.full_like(self.parents, -1)])

    def _add_chain(self, from_idx: int, base: np.ndarray, direction: np.ndarray,
                   distance: float, n_steps: int) -> int:
        """Add n_steps nodes along direction from base, chained parents."""
        self._grow_capacity(self.n_nodes + n_steps)
        parent = from_idx
        for i in range(n_steps):
            p = base + direction * min(self.step_size * (i + 1), distance)
            self.nodes[self.n_nodes] = p
            self.parents[self.n_nodes] = parent
            parent = self.n_nodes
            self.n_nodes += 1
        return n_steps

    # ------------------------------------------------------------- queries
    def _nearest(self, point: np.ndarray) -> int:
        d = np.linalg.norm(self.nodes[:self.n_nodes] - point, axis=1)
        return int(np.argmin(d))

    def _random_point(self, full_range: bool) -> np.ndarray:
        rs = self.full_ranges if full_range else (self.x_range, self.y_range,
                                                  self.z_range)
        return np.array([self.rng.uniform(lo, hi) for lo, hi in rs])

    # ----------------------------------------------------------- extension
    def _extend_random(self, full_range: bool = False) -> int:
        """Amplified random extension; returns number of nodes added."""
        rp = self._random_point(full_range)
        ni = self._nearest(rp)
        base = self.nodes[ni]
        diff = rp - base
        dist = np.linalg.norm(diff)
        reach = self.step_size * self.step_amplifier
        if dist > reach:
            target = base + diff / dist * reach
        else:
            target = rp
        n_free, _ = is_collision_free(base, target, self.sdf_map,
                                      self.step_size, self.collision_thre)
        if n_free <= 0:
            return 0
        diff = target - base
        dist = np.linalg.norm(diff)
        if dist < 1e-9:
            return 0
        return self._add_chain(ni, base, diff / dist, dist, n_free)

    def _extend_straight(self) -> bool:
        """Greedy straight-line extension from the latest node toward the
        goal; returns True if the goal was reached."""
        last = self.n_nodes - 1
        base = self.nodes[last]
        n_free, _ = is_collision_free(self.goal, base, self.sdf_map,
                                      self.step_size, self.collision_thre)
        if n_free <= 0:
            return False
        diff = self.goal - base
        dist = np.linalg.norm(diff)
        if dist < 1e-9:
            return True
        self._add_chain(last, base, diff / dist, dist, n_free)
        return bool(np.linalg.norm(self.nodes[self.n_nodes - 1] - self.goal)
                    < self.step_size)

    # ---------------------------------------------------------------- runs
    def run(self) -> bool:
        for _ in range(self.max_iter):
            self.rrt_iter += 1
            if self.enable_direct_line:
                if self._extend_straight():
                    break
                n_new = self._extend_random()
            else:
                n_new = self._extend_random()
            if n_new > 0:
                tail = self.nodes[self.n_nodes - n_new:self.n_nodes]
                if np.linalg.norm(tail - self.goal, axis=1).min() \
                        < self.step_size:
                    break
        nearest = self._nearest(self.goal)
        self.goal_parent = nearest
        reachable = (np.linalg.norm(self.nodes[nearest] - self.goal)
                     <= self.step_size)
        return bool(reachable)

    def run_full(self) -> None:
        """Dense growth over the full volume for traversability estimation."""
        for _ in range(self.full_iters):
            self._extend_random(full_range=True)

    # ---------------------------------------------------------------- path
    def find_path(self) -> List[np.ndarray]:
        path = [self.goal.copy()]
        cur = self.goal_parent
        while cur >= 0:
            path.append(self.nodes[cur].copy())
            cur = int(self.parents[cur])
        return path

    def get_reachable_mask(self) -> np.ndarray:
        """[X,Y,Z] float mask: 1 where some tree node is within step_size."""
        X, Y, Z = self.vol_shape
        gx, gy, gz = np.meshgrid(np.arange(X), np.arange(Y), np.arange(Z),
                                 indexing="ij")
        pts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3).astype(np.float64)
        tree = cKDTree(self.nodes[:self.n_nodes])
        dist, _ = tree.query(pts, k=1)
        return (dist <= self.step_size).astype(np.float32).reshape(X, Y, Z)

    # ---------------------------------------------------------------- eval
    def update_eval(self, is_valid_planning: bool, time: float,
                    path: List[np.ndarray]) -> None:
        if not is_valid_planning:
            return
        self.eval_results["time_ms"].append(time * 1000.0)
        self.eval_results["node_num"].append(self.n_nodes)
        self.eval_results["rrt_iter"].append(self.rrt_iter)

    def print_eval_result(self, printer) -> None:
        printer("RRT evaluation:")
        for k, v in self.eval_results.items():
            if v:
                printer(f"  {k}: {np.mean(v):.2f}")
