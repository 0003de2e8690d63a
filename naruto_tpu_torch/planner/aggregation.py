"""Uncertainty aggregation over the goal space, on the torch device
(counterpart of naruto_tpu/planner/aggregation.py, whose jitted ``lax.map``
over goal chunks this runs as a loop of eager chunks).

Behavioral contract from src/planner/naruto_planner.py:596-735
(uncertainty_aggregation_v2):
  * target candidates = a random subset (uncert_top_k_subset=300) of the
    top-k (4000) most uncertain voxels of the (traversability-filtered)
    uncertainty volume;
  * a (goal, target) pair is valid iff: distance within the sensing range
    [0.5m, 2m] (in voxels); the goal is "safe" (not at the volume border and
    all 6 axis neighbors have SDF >= safe_sdf); and the target is visible
    from the goal (all 30 points of the ray march goal->target, truncated to
    integer voxel indices, have SDF > 0);
  * a goal's aggregated score = sum of the uncertainties of its valid
    targets; per-pair contributions are also returned for look-at selection.

The subset draw is an argument: the indices ``sel`` into the top-k, or a
function of the top-k values that draws them (the planner's, from its own
generator). Tests pass in the JAX package's ``jax.random.choice`` draws.

What keeps the result equal to the JAX package's: the top-k orders ties
lower flat index first, as ``jax.lax.top_k`` does (a stable descending
sort); the march's parameters are JAX's float32 values; and ``t * view`` is
rounded before ``gp - ...``. Where the host's XLA contracts that into a fused
multiply-add instead, the truncation still agrees: with 30 points a march
point's exact value ``gp - k * view / 29`` is an integer only where 29 (a
prime) divides a component of ``view``, and a pair within the 2 m sensing
range has every component below 20 voxels.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Tuple, Union

import numpy as np
import torch

from naruto_tpu_torch.ops import unit_linspace


class GoalSpace(NamedTuple):
    x_range: np.ndarray  # [Gx] voxel levels
    y_range: np.ndarray
    z_range: np.ndarray
    points: np.ndarray   # [G, 3] voxel coords (float)

    @property
    def shape(self) -> Tuple[int, int, int]:
        return (len(self.x_range), len(self.y_range), len(self.z_range))


def make_goal_space(vol_shape, voxel_size: float,
                    gs_z_levels=None) -> GoalSpace:
    """Every 2nd voxel in X,Y; configurable Z levels (default one per meter
    starting at 1m — ref naruto_planner.py:123-137 with the shipped
    gs_z_levels=None)."""
    X, Y, Z = vol_shape
    xr = np.arange(0, X, 2)
    yr = np.arange(0, Y, 2)
    if gs_z_levels is None:
        step = max(int(1.0 / voxel_size), 1)
        zr = np.arange(step, Z, step)
        if len(zr) == 0:
            zr = np.array([Z // 2])
    else:
        zr = np.asarray(gs_z_levels)
    gx, gy, gz = np.meshgrid(xr, yr, zr, indexing="ij")
    pts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3).astype(np.float32)
    return GoalSpace(xr, yr, zr, pts)


class AggregationOutputs(NamedTuple):
    gs_aggre: torch.Tensor         # [Gx, Gy, Gz]
    topk_vxl: torch.Tensor         # [K, 3] int32
    collections: torch.Tensor      # [G, K]
    any_valid: torch.Tensor        # [] bool


Draw = Union[torch.Tensor, Callable[[torch.Tensor], torch.Tensor]]


class Aggregator:
    """The aggregation for a fixed volume/goal-space shape on one device.

    Goals are processed in chunks of `goal_chunk`: the dense [G, K, n_vis]
    visibility tensor for MP3D-size scenes (G ~ 20k) would otherwise peak at
    several GB; chunking bounds the working set at ~goal_chunk * K * n_vis
    elements with no behavioral change.
    """

    def __init__(self, vol_shape, gs: GoalSpace, voxel_size: float,
                 top_k: int = 4000, subset: int = 300,
                 sensing_range=(0.5, 2.0), safe_sdf: float = 0.8,
                 n_vis_pts: int = 30, goal_chunk: int = 2048,
                 subset_nonzero_weighted: bool = True, device="cuda"):
        X, Y, Z = vol_shape
        self.vol_shape = (X, Y, Z)
        self.gs = gs
        self.device = dev = torch.device(device)
        self.subset_nonzero_weighted = subset_nonzero_weighted
        goal_pts = np.asarray(gs.points, dtype=np.float32)      # [G, 3]
        self.n_goals = G = goal_pts.shape[0]
        self.k_eff = min(top_k, X * Y * Z)
        self.subset_eff = min(subset, self.k_eff)
        # the thresholds as the float32 values JAX compares against
        self.min_d = float(np.float32(sensing_range[0] / voxel_size))
        self.max_d = float(np.float32(sensing_range[1] / voxel_size))
        self.safe_sdf = float(np.float32(safe_sdf))

        # pad goals to a chunk multiple (padded goals masked invalid)
        self.chunk = chunk = min(goal_chunk, max(G, 1))
        n_chunks = -(-G // chunk)
        pad = n_chunks * chunk - G
        goal_pts_pad = np.concatenate(
            [goal_pts, np.zeros((pad, 3), np.float32)])
        goal_real = np.concatenate([np.ones(G, bool), np.zeros(pad, bool)])
        gxi = goal_pts_pad.astype(np.int64)
        border = ((gxi[:, 0] < 1) | (gxi[:, 0] + 1 >= X)
                  | (gxi[:, 1] < 1) | (gxi[:, 1] + 1 >= Y)
                  | (gxi[:, 2] < 1) | (gxi[:, 2] + 1 >= Z))
        offsets = np.asarray(
            [[0, 0, 0], [1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
             [0, 0, 1], [0, 0, -1]], dtype=np.int64)
        nb = np.clip(gxi[:, None, :] + offsets[None], 0,
                     np.asarray([X - 1, Y - 1, Z - 1]))
        nb_flat = (nb[..., 0] * Y + nb[..., 1]) * Z + nb[..., 2]  # [Gp, 7]

        def chunks(a):
            return torch.from_numpy(a.reshape(n_chunks, chunk,
                                              *a.shape[1:])).to(dev)

        self.goal_pts_c = chunks(goal_pts_pad)
        self.goal_real_c = chunks(goal_real)
        self.border_c = chunks(border)
        self.nb_flat_c = chunks(nb_flat)
        self.t_vals = torch.from_numpy(unit_linspace(n_vis_pts)).to(dev)

    def draw_subset(self, top_vals: torch.Tensor,
                    generator: torch.Generator) -> torch.Tensor:
        """The subset of the top-k: `subset` distinct indices in
        [0, k_eff). DEVIATION #12 (PARITY.md, default ON,
        planner.subset_nonzero_weighted): weight the draw toward NONZERO
        entries so sparse uncertainty volumes still yield usable targets;
        False = unweighted draw, matching the reference's arbitrary
        unweighted slice semantics."""
        if self.subset_nonzero_weighted:
            nz = (top_vals > 0).to(torch.float32)
            p = torch.where(nz.sum() >= self.subset_eff, nz,
                            torch.ones_like(nz)) + 1e-9
            return torch.multinomial(p, self.subset_eff, replacement=False,
                                     generator=generator)
        return torch.randperm(self.k_eff, generator=generator,
                              device=top_vals.device)[:self.subset_eff]

    @torch.no_grad()
    def __call__(self, uncert: torch.Tensor, sdf: torch.Tensor,
                 sel: Draw) -> AggregationOutputs:
        """uncert, sdf: [X, Y, Z] on the device; sel: [subset] indices into
        the top-k, or a function of the top-k values [k_eff] that returns
        them."""
        X, Y, Z = self.vol_shape
        flat = uncert.reshape(-1)
        # the k largest, ties lower flat index first (as jax.lax.top_k)
        order = torch.sort(flat, descending=True, stable=True)
        top_vals = order.values[:self.k_eff]
        top_idx = order.indices[:self.k_eff]
        if callable(sel):
            sel = sel(top_vals)
        chosen = top_idx[sel.to(self.device)]
        tvox = torch.stack([chosen // (Y * Z), (chosen // Z) % Y, chosen % Z],
                           dim=-1)                              # [K, 3]
        tvox_f = tvox.to(torch.float32)
        u_k = flat[chosen]                                      # [K]
        sdf_flat = sdf.reshape(-1)
        t = self.t_vals

        cols, any_valid = [], torch.zeros((), dtype=torch.bool,
                                          device=self.device)
        for gp, greal, gborder, nbf in zip(self.goal_pts_c, self.goal_real_c,
                                           self.border_c, self.nb_flat_c):
            view = gp[:, None, :] - tvox_f[None, :, :]          # [C, K, 3]
            dist = torch.sqrt((view * view).sum(-1))
            dist_ok = (dist > self.min_d) & (dist < self.max_d)
            unsafe = gborder | (sdf_flat[nbf] < self.safe_sdf).any(-1)
            # the march, one axis at a time: truncate toward zero, clip,
            # and fold into the flat voxel index
            vi = None
            for a, size in enumerate((X, Y, Z)):
                scaled = t[None, None, :] * view[:, :, None, a]
                pa = gp[:, None, None, a] - scaled              # [C, K, n]
                ia = pa.to(torch.int32).clamp_(0, size - 1)
                vi = ia if vi is None else vi * size + ia
            vis_sdf = sdf_flat[vi.long()]
            visible = vis_sdf.amin(-1) > 0.0
            valid = (dist_ok & ~unsafe[:, None] & visible & greal[:, None])
            cols.append(torch.where(valid, u_k[None, :], 0.0))
            any_valid = any_valid | valid.any()
        collections = torch.cat(cols)[:self.n_goals]
        aggre = collections.sum(-1).reshape(self.gs.shape)
        return AggregationOutputs(gs_aggre=aggre,
                                  topk_vxl=tvox.to(torch.int32),
                                  collections=collections,
                                  any_valid=any_valid)
