"""The work of a BA iteration and of its kernel sites, counted from the
configuration's shapes, and the published peaks of one NVIDIA H100 SXM
(dense, no sparsity, at its 700 W limit).

What is counted is what the algorithm needs, not what an implementation
happens to move, so the counts read the same whatever later computes them:

* A BA iteration renders ``sample + cur_cap/4`` rays of
  ``n_range_d + n_samples_d`` samples (P points through the whole field)
  and, with the smoothness term, Q lattice points through the hash grid
  alone ((smooth_pts-1)^3).
* FLOPs: the two MLPs forward (2 per multiply-add) and backward (twice
  the forward: the cotangents of the activations and of the weights), on
  the P points; the hash grid's trilinear blend on the P + Q points and L
  levels, forward (8 corner weights, two products each, and 8F
  multiply-adds) and backward (8F products into the corner rows, 8F
  multiply-adds into the weights' cotangent).
* Bytes: each iteration's optimizer steps read and write every parameter
  it steps once with its two moments (6 x 4 bytes a float32 parameter:
  the table and the decoders every iteration, the uncertainty grid every
  ``uncert_accum_iters``-th, its float32 gradient sum read and written
  every iteration), and it reads its batch: the sampled keyframe and
  current rays (7 floats), the draws (an index a ray, S noise values a
  rendered ray). Everything else could stay on the chip.
* A kernel site reads each input once and writes each output once.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from reference import Grid, param_shapes

PEAK_BYTES_S = 3.35e12        # HBM3
PEAK_F32_S = 67e12            # float32 outside the tensor cores


def ba_points(cfg: dict, cur_cap: int) -> Tuple[int, int, int]:
    """(rays, P field points, Q lattice points) of one BA iteration."""
    m, t = cfg["mapper"], cfg["training"]
    rays = (m["sample"] + cur_cap // 4 if m["active_ray"]
            else m["sample"] * m["act_ray_oversample_mul"] + cur_cap)
    s = t["n_range_d"] + t["n_samples_d"]
    q = 0
    if t["smooth_weight"] > 0:
        q = (6 * t["smooth_sample"] if t["smooth_sample"]
             else (t["smooth_pts"] - 1) ** 3)
    return rays, rays * s, q


def ba_iteration_work(cfg: dict, cur_cap: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one BA iteration at the bucket cur_cap."""
    g = Grid(cfg)
    rays, p, q = ba_points(cfg, cur_cap)
    shapes = param_shapes(cfg)
    macs = sum(a * b for a, b in shapes["decoder"])
    flops = 6.0 * p * macs
    flops += (p + q) * g.L * (16 + 2 * 8 * g.F + 2 * 8 * g.F)
    every = sum(int(np.prod(s)) for k in ("table", "decoder")
                for s in shapes[k])
    unc = int(np.prod(shapes["uncert"][0]))
    m = cfg["mapper"]
    nbytes = 6 * 4 * every + 6 * 4 * unc / m["uncert_accum_iters"] \
        + 2 * 4 * unc
    n_os = m["sample"] * m["act_ray_oversample_mul"]
    s = cfg["training"]["n_range_d"] + cfg["training"]["n_samples_d"]
    nbytes += (n_os + cur_cap) * (7 * 4 + 8) + rays * s * 4 + 6 * 4
    return float(flops), float(nbytes)


def least_seconds(flops: float, nbytes: float) -> Tuple[float, str]:
    """The least time of the work on the chip and which bound sets it."""
    by_ops, by_bytes = flops / PEAK_F32_S, nbytes / PEAK_BYTES_S
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "flops")


def outer_scan_slots_bytes(rows: int, cols_a: int, cols_b: int,
                           slots: int) -> int:
    """The cell rows' hash backward: `rows` sorted (point, level) updates,
    each a bf16 row of cols_a corner factors and cols_b cotangents and an
    int32 key, into float32 slot rows [slots, cols_a * cols_b]."""
    return rows * ((cols_a + cols_b) * 2 + 4) + slots * cols_a * cols_b * 4


def vertex_segment_sum_bytes(rows: int, features: int, slots: int) -> int:
    """The vertex rows' hash backward fed the sort's permutation: per
    update an int32 sorted key, its permutation index (torch.sort's
    int64) and a float32 row of `features`, into float32 [slots,
    features]."""
    return rows * (4 + 8 + 4 * features) + slots * features * 4


def site_bytes(cfg: dict, cur_cap: int) -> dict:
    """Bytes of the hash backward's kernel site at one BA iteration, by
    kernel: outer_scan_slots for cell rows, sorted_segment_sum for
    vertex rows."""
    g = Grid(cfg)
    _, p, q = ba_points(cfg, cur_cap)
    if g.cell:
        return {"outer_scan_slots": outer_scan_slots_bytes(
            (p + q) * g.L, 8, g.F, g.total)}
    return {"sorted_segment_sum": vertex_segment_sum_bytes(
        (p + q) * g.L * 8, g.F, g.total)}
