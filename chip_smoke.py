#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (naruto_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--profile DIR]

Phases (any failure exits non-zero, and nothing is printed as a result):
  1. device and build: torch/CUDA versions, the card's name and power
     limit, every kernel of the port compiled from csrc/ (one nvcc per
     source, all started together);
  2. the fused hash-backward scan, both epilogues (full rows, slot rows)
     against their plain PyTorch versions on the same card tensors, at the
     mapping step's shape (M = 493,568 rows, 8 x 8, 204,089 slots) and at
     small shapes; two calls must agree bit for bit; both timed (CUDA
     events, and the profiler's device time);
  3. segment sums: the hash-grid backward's segment sum, and the
     uncertainty grid's trilinear VJP (sort, gather_rows,
     sorted_segment_sum), through the kernels on the card against the same
     functions through the plain versions on the host, at the mapping
     step's point counts, table size and (49, 56, 35) grid;
  4. the slice: the mapper's online entry point at the full Replica/office0
     defaults (680x1200 frames rendered by the analytic simulator, L4F8
     hybrid hash grid, active-ray BA with 43 samples per ray), steps 0..10;
     the keyframe store filled to 22 keyframes; a warm window of BA steps
     timed as bench.py times the JAX package (mapping iterations / s).
     Every BA iteration must launch each kernel entry point of the path
     its fixed number of times (BA_LAUNCHES_PER_ITER);
  5. the primitives: the kernels gather_rows, sorted_segment_sum
     (bf16-rounded and exact f32) and row_cumsum against their plain
     versions on the same card tensors at the microbenchmark scripts' sizes
     (M = 3,000,000 updates, 201,088 slots, a 65,536-row level table), at
     the BA path's shapes and at ragged small M, both timed (CUDA events,
     and at the large shapes also the profiler's device time);
     sorted_segment_sum also on key layouts that stress its tiling (one key
     on most rows, empty leading and trailing slots, long gaps, M beside a
     tile multiple); two row_cumsum or sorted_segment_sum calls must agree
     bit for bit; the host's cost per call of
     every wrapper and plain version; then both ported microbenchmark
     scripts run in this process, and their launch counts show every
     kernel ran;
  6. the passive run: the port's Engine on configs/ab/passive_traj_ab.yaml
     (1,000 steps of data/traj_ab/traj.txt on the analytic office0 room,
     the full-width defaults of phase 4) through run() and finalize(), as
     `python -m naruto_tpu_torch.run` drives it: the final mesh at
     mesh.voxel_final (the field's dense query in chunks of 2^20 points,
     marching tets, vertex colours), the checkpoint, and the metric row.
     The row must hold the trajectory's length (33.179382 m within 1e-4),
     completion ratio >= 99.0% and MAD <= 0.572 cm (the JAX package's
     0.472 cm plus 0.1 cm), and every BA iteration of the run must launch
     BA_LAUNCHES_PER_ITER. It prints the row beside the JAX package's, the
     run's wall time and timer sections, and the final extraction's seconds
     by stage (one extraction chunk's device time and kernels:
     `python -m naruto_tpu_torch.scripts.probe_passive`). Every kernel
     wrapper call of the run is counted by its shapes, and the inputs of
     the first call at each shape are kept: the BA's at every keyframe
     bucket, the volumes', the snapshots', the final extraction's (2^20-
     point chunks and the ragged last one), the colours' and the MAD's.
     After the run each is held against its plain version on those inputs.
  7. the active run: configs/Replica/office0/naruto.yaml, 2,000 steps at
     ACTIVE_SEED, through run() and finalize(): the planner's gates, the
     aggregation's device time a plan, the launch check and the replays of
     phase 6;
  8. the parity grid: phase 6's run, uncut, with the grid: section of
     configs/parity.yaml (the vertex layout: 16 levels of 2 features, an
     f32 table of 814,897 rows); its row held to the JAX package's for the
     same poses (trajectory within 1e-4 m, ratio >= 99.0%, MAD <= its
     0.459 cm + 0.1 cm), PARITY_LAUNCHES_PER_ITER in every BA iteration,
     and the replays of phase 6 (the vertex backward's segment sum over
     15.8M rows of F = 2, the forward's gather of [814,897, 2] f32 rows);
  9. the remaining settings: phase 6's run with tracking (schema defaults:
     10 iterations of 1,024 rays a frame), n_importance 12, smooth_sample
     4,096 and the weights carry on the default hybrid grid, cut to
     SETTINGS_STEPS steps: every pose finite, SETTINGS_LAUNCHES_PER_ITER in
     every BA iteration and TRACK_LAUNCHES_PER_ITER in every tracking
     iteration, and the replays; the tracked poses against the
     trajectory's are printed beside its largest steps (10-degree turns,
     beyond what 10 tracking iterations can move a pose). Then the mapper
     with the same settings tracks TRACK_PATH_STEPS frames of a
     constant-speed path at half a tracking call's reach: the tracked
     translations within MAX_TRACK_RMSE_CM (RMSE) and MAX_TRACK_ERR_CM
     (worst frame) of the path's.
 10. the raycast run: office0's analytic room synthesised as a mesh at
     mesh.voxel_eval (naruto_tpu_torch/scripts/make_scene_assets.py, to a
     temporary directory), then phase 7's run on it through the raycast
     simulator (the C++ BVH renderer on the host) at RAYCAST_SEED, with
     phase 7's gates, launch check and replays; its ground truth is the
     mesh. The row is printed beside the JAX package's raycast rows, with
     the host's ms a frame, the wall, the peak memory; at the first
     RENDER_CHECK_POSES rendered poses the renderer is held against the
     analytic scene (median depth difference, the ERP probe's closest
     distance) and against itself (two renders, bit for bit).
 11. resume: phase 6 writes its snapshot at PASSIVE_SNAPSHOT_STEP (its row
     must stay the row without snapshots); a fresh Engine resumes from it
     and must end with phase 6's poses bit for bit and its row digit for
     digit. Phase 10 writes its snapshot at RAYCAST_SNAPSHOT_STEP; a fresh
     Engine resumes from it until RESUME_STEPS_AFTER_RRT steps after the
     RRT's first draw, with phase 10's poses bit for bit until that draw.
     The snapshots' sizes and the seconds to write and to load them are
     printed.
 12. replay: the image codec (utils/image_io.py, native/image_codec.cpp)
     held to its contracts at 680x1200 (PNG uint8 and uint16 round trips
     exact, a JPEG round trip of an analytic frame at >= CODEC_MIN_PSNR_DB,
     jet equal to matplotlib's values pinned in JET_PINNED), with its
     decode and encode ms; then the first REPLAY_STEPS poses of
     data/traj_ab/traj.txt captured from the analytic office0 room by
     sim/scripted.py (frame JPEGs, 16-bit depth PNGs, traj.txt) into a
     temporary directory, and phase 6's run cut to REPLAY_STEPS steps
     twice: on the analytic simulator, then over sim.method replay of the
     capture (with the analytic run's gt_mesh.ply beside it as mesh.ply).
     The replayed trajectory must be the analytic one within TRAJ_TOL, its
     ratio within REPLAY_RATIO_PTS points and its MAD within REPLAY_MAD_CM
     of the analytic run's; the replays of phase 6 on both runs. The ms a
     frame to capture (render + encode) and to replay (decode + copy), and
     both runs' walls, are printed.
 13. --enable_vis: phase 7's run (ACTIVE_SEED, its configuration) for
     VIS_STEPS steps with vis.enable_all_vis and vis.vis_rgbd, then every
     mode of visualization/offline.py on its visualization/ directory
     (traj, mesh_evo on both mesh kinds, video, replay at stride
     VIS_REPLAY_STRIDE with its AVI) and export_pose on the run's
     checkpoint. VIS_STEPS files in each per-step directory and
     VIS_STEPS / save_mesh_freq in each mesh directory; every PNG and AVI
     frame decodes to its shape; the uncertainty meshes' colours lie on
     the jet table; export_pose's array equals the run's poses, and the
     VIS_STEPS poses equal phase 7's first VIS_STEPS bit for bit (the
     saver only renders frames and reads the field).
 14. data-parallel: phase 4's mapper at full width (office0, steps 0..5,
     the keyframe store filled to SHARDED_KEYFRAMES) on SHARDED_RANKS
     ranks spawned on the one card (naruto_tpu_torch/parallel/dryrun.py's
     worker; the backend that parallel/mesh.py's rule picks, Gloo where
     ranks share a card), with parallel.shard_rays and shard_volumes: one
     BA iteration's gradients from the same state and draws against the
     single-process gradient (SHARDED_GRAD_TOL), the (49, 56, 35) volume
     query against the unsharded one (SHARDED_VOL_TOL) on SHARDED_RANKS
     and on SHARDED_PAD_RANKS ranks (which pads the voxel axis), then
     SHARDED_STEPS BA steps, then SHARDED_SITE_STEPS with each collective
     timed alone, after which the field and the table's Adam moments must
     be bit-identical across ranks; every BA iteration of a rank launches
     BA_LAUNCHES_PER_ITER and makes SHARDED_COLLECTIVES_PER_ITER, a volume
     query one collective. The wall of a BA iteration at 1 rank and at
     SHARDED_RANKS (ranks sharing one card: not a scaling figure), and the
     collectives' share of it; every (kernel, shape) of rank 0 at
     the half-batch shapes replayed against its plain version; then phase
     7's run (ACTIVE_SEED) cut to SHARDED_ACTIVE_STEPS steps on
     SHARDED_RANKS ranks, equal poses on every rank, rank 0's row.

Every timed case also states its bound (the larger of the bytes it must
move over the card's memory rate and its operations over the card's f32
rate, from the published H100 SXM peaks) and, where one PyTorch call
computes the same function, that call's time.

The last line is {"ok": true, "device": {...}}; the line before it is the
card's name and power limit, and the line before that the kernels' JSON
(each kernel's launches on every path that drives it: the slice of phase
4, the microbenchmarks of phase 5, the passive run of phase 6, the active
run of phase 7, the parity run of phase 8, the settings run of phase 9,
the raycast run of phase 10, the two resumed runs of phase 11, the
replayed run of phase 12, the --enable_vis run of phase 13, rank 0 of the
data-parallel phase 14).
"""
from __future__ import annotations

import argparse
import importlib.abc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

KERNEL_TOL = 1e-6          # max |kernel - plain| / max |plain|
SEGMENT_TOL = 2e-6         # max |card - host| / max |cumsum of slot sums|
# the mapping step's hash backward at office0: 493,436 updates padded to
# 493,568 rows, 8 x 8, 204,089 table rows
SLICE_N, SLICE_M, SLICE_SLOTS, SLICE_K = 493_436, 493_568, 204_089, 8
SMALL_SHAPES = ((512, 8, 4), (4608, 8, 4), (512, 2, 2), (4608, 2, 2))
INT32_MAX = 2 ** 31 - 1
WINDOW_STEPS = 20          # timed BA steps in the warm window
PRIM_M, PRIM_T, PRIM_TS, PRIM_F = 3_000_000, 201_000, 65_536, 8
RAGGED_M = (1, 2049, 5000)  # no multiple of any TPU block
RAGGED_SLOTS = 4000
PRIM_REPS = 50
LIBRARY_REPS = 3           # torch.cumsum(x, 0) at [3M, 8] takes ~0.75 s
HOST_CALLS = 200           # calls enqueued back to back per host-cost line
# NVIDIA H100 SXM peaks (data sheet): HBM bytes/s, f32 FLOP/s outside the
# tensor cores
PEAK_BYTES_S, PEAK_F32_S = 3.35e12, 67e12
# launches of each kernel entry point in one BA iteration: the fused scan's
# slot rows in the hash backward (never its full rows); gather_rows for the
# hash forward, the backward's two payload gathers, the uncertainty grid's
# cell gather and its trilinear VJP's gather by the sort permutation;
# sorted_segment_sum for that VJP's segment sum; row_cumsum nowhere
BA_LAUNCHES_PER_ITER = {"outer_scan_slots": 1, "outer_scan_rows": 0,
                        "gather_rows": 5, "row_cumsum": 0,
                        "sorted_segment_sum": 1}
BACKWARD_KERNELS = ("outer_scan_slots",)   # only in the backward
SLICE_KERNELS = tuple(BA_LAUNCHES_PER_ITER)
PRIM_KERNELS = ("gather_rows", "sorted_segment_sum", "row_cumsum")
# the BA path's gathers at office0, with int64 indices: (site, table rows,
# width, dtype, M, whether the indices come sorted, as ranks do)
BA_GATHERS = (
    ("hash forward", 204_089, 64, "bfloat16", 493_436, False),
    ("sort payload", 493_568, 1, "int32", 493_568, False),
    ("sort payload", 493_568, 8, "bfloat16", 493_568, False),
    ("uncert cells", 89_760, 8, "float32", 93_568, False),
    ("segment rows", 93_568, 8, "float32", 93_568, False),
)
# the uncertainty grid at office0: the trilinear VJP sums BA_POINTS rows of
# 8 corner weights into the cells of a (49, 56, 35) grid
UNCERT_SHAPE, BA_RAYS, BA_SAMPLES = (49, 56, 35), 2176, 43
BA_POINTS, BA_CELLS = BA_RAYS * BA_SAMPLES, 48 * 55 * 34
# sorted_segment_sum on keys that stress its tiling: (layout, rows, slots).
# At 8 columns a tile has 512 rows below ~1M rows and 2,048 at 3M.
SEGMENT_LAYOUTS = (
    ("one key on 60% of the rows", 3_000_000, 201_088),
    ("one key on 60% of the rows", 300_000, 5000),
    ("first key late", 20_000, 9000),
    ("last key early", 20_000, 9000),
    ("long gaps", 5000, 200_000),
    ("uniform, a tile multiple - 1", 512 * 9 - 1, 3000),
    ("uniform, a tile multiple + 1", 512 * 9 + 1, 3000),
    ("uniform, a tile multiple + 1", 2048 * 1465 + 1, 201_088),
)
# phase 6: the passive run and the JAX package's row for it
# (results/ab_r4_parity_traj/Replica/office0/eval_result.txt)
PASSIVE_CFG = "configs/ab/passive_traj_ab.yaml"
REFERENCE_ROW = {"traj_length_m": 33.179382, "accuracy_cm": 1.307488,
                 "completion_cm": 1.282566, "completion_ratio_pct": 99.63,
                 "fscore_pct": 99.517122, "mad_cm": 0.472080}
TRAJ_TOL = 1e-4            # the poses are the file's: exact up to printing
MIN_RATIO_PCT = 99.0
MAD_MARGIN_CM = 0.1        # Gate S4: the reference's MAD plus 0.1 cm
# phase 7: the active run, and the JAX package's rows of the same protocol
# (2,000 steps, seeds 0/500/1000/1500/1999; PERFORMANCE.md "5-seed
# protocol"). Seeds 0 and 500 of the port fall into the reference's
# collision livelock (PERFORMANCE.md, raycast seed_1999: the agent wedged
# at the learned surface, every plan's first move collides); seed 1 is the
# lowest seed whose run does not (PERF.md, section 6).
# phase 8: the passive run on configs/parity.yaml's grid (the vertex
# layout), and the JAX package's row for it, from a mapper of three rounds
# before (results/ab_passive_vertex/Replica/office0/eval_result.txt; it has
# no F-score column)
PARITY_CFG = "configs/parity.yaml"
PARITY_ROW = {"traj_length_m": 33.179382, "accuracy_cm": 1.357286,
              "completion_cm": 1.288284, "completion_ratio_pct": 99.609,
              "mad_cm": 0.459087}
# its BA iteration: gather_rows for the hash forward (one row of F = 2 per
# corner), the uncertainty grid's cell gather, and the two segment sums'
# gathers by their sort permutations; sorted_segment_sum for the vertex
# rows (bf16-rounded) and the trilinear VJP (exact); no fused scan
PARITY_LAUNCHES_PER_ITER = {"outer_scan_slots": 0, "outer_scan_rows": 0,
                            "gather_rows": 4, "row_cumsum": 0,
                            "sorted_segment_sum": 2}
# phase 9: the passive protocol with the remaining settings, cut to
# SETTINGS_STEPS steps (schema defaults: 10 tracking iterations of 1,024
# rays), on the default hybrid grid
SETTINGS_STEPS = 200
SETTINGS_OVER = {"mapper": {"tracking_enable": True},
                 "training": {"n_importance": 12, "smooth_sample": 4096},
                 "grid": {"sort_carry": "weights"}}
# its BA iteration (poses optimised): the hash encode runs twice, the first
# pass with the smoothness pairs riding it; gather_rows for both forwards,
# both uncertainty-grid lookups, each backward's two payload gathers (the
# weights carry) and its position gradient's feature gather, and the
# trilinear VJP's gather; the slot-row scan in both hash backwards; one
# sorted_segment_sum (the trilinear VJP: no loss reads the first pass's
# uncertainty)
SETTINGS_LAUNCHES_PER_ITER = {"outer_scan_slots": 2, "outer_scan_rows": 0,
                              "gather_rows": 11, "row_cumsum": 0,
                              "sorted_segment_sum": 1}
# a tracking iteration (the field frozen): both forwards' hash and
# uncertainty gathers, and the position gradient's feature gather; no
# table gradient, so no segment sum and no scan
TRACK_LAUNCHES_PER_ITER = {"outer_scan_slots": 0, "outer_scan_rows": 0,
                           "gather_rows": 5, "row_cumsum": 0,
                           "sorted_segment_sum": 0}
MAX_TRACK_RMSE_CM, MAX_TRACK_ERR_CM = 5.0, 10.0
TRACK_PATH_STEPS = 40
ACTIVE_CFG = "configs/Replica/office0/naruto.yaml"
ACTIVE_SEED = 1
JAX_ACTIVE_ROWS = "results/seeds_r3/Replica/office0/seed_{}/Replica/office0/" \
    "eval_result.txt"
JAX_ACTIVE_SEEDS = (0, 500, 1000, 1500, 1999)
FSM_STATES = ("staying", "planning", "rotationPlanningAtStart",
              "rotatingAtStart", "movingToGoal", "rotationPlanningAtGoal",
              "rotatingAtGoal")
MIN_PLANS, MIN_TRAJ_M, MIN_ACTIVE_RATIO_PCT = 10, 15.0, 90.0
MAX_ACTIVE_MAD_CM, MAX_ACTIVE_ACC_CM, MAX_ACTIVE_COMP_CM = 1.0, 2.5, 2.5
# phase 10: the active run on office0's mesh through the raycast simulator,
# with phase 7's gates; the JAX package's rows of the same protocol
# (PERFORMANCE.md, raycast backend, five seeds)
RAYCAST_SEED = ACTIVE_SEED
JAX_RAYCAST_ROWS = "results/seeds_r3_raycast/Replica/office0/seed_{}/" \
    "Replica/office0/eval_result.txt"
RENDER_CHECK_POSES = 5     # rendered poses held against the analytic scene
# phase 11: the snapshots the runs write (general.ckpt_freq) and resume from
PASSIVE_SNAPSHOT_STEP = 500
RAYCAST_SNAPSHOT_STEP = 1000
RESUME_STEPS_AFTER_RRT = 5  # the resumed active run stops this many after
# phase 6's row without snapshots (PERF.md section 2: the same digits in
# every run on the card): a run that writes snapshots must not move it
PORT_PASSIVE_ROW = {"traj_length_m": 33.179382, "accuracy_cm": 1.307809,
                    "completion_cm": 1.279369,
                    "completion_ratio_pct": 99.6265,
                    "fscore_pct": 99.495077, "mad_cm": 0.463325}
# phase 12: the codec, the capture and the replayed passive run
REPLAY_STEPS = 200
REPLAY_RATIO_PTS = 0.5     # |replayed - analytic| completion ratio, points
REPLAY_MAD_CM = 0.05       # |replayed - analytic| MAD
CODEC_MIN_PSNR_DB = 40.0   # quality 95, 4:2:0, a 680x1200 frame (43-51 dB)
CODEC_REPS = 5
# matplotlib.cm.jet(i)[:3] (matplotlib 3.10) at these table indices
JET_PINNED = {
    0: (0.0, 0.0, 0.5),
    32: (0.0, 0.00196078431372549, 1.0),
    64: (0.0, 0.503921568627451, 1.0),
    96: (0.08538899430740036, 1.0, 0.8823529411764706),
    128: (0.4901960784313725, 1.0, 0.4775458570524984),
    160: (0.8950031625553446, 1.0, 0.07273877292852626),
    192: (1.0, 0.5816993464052289, 0.0),
    224: (1.0, 0.11692084241103862, 0.0),
    255: (0.5, 0.0, 0.0)}
# phase 13: the --enable_vis run and the offline tools
VIS_STEPS = 60
VIS_REPLAY_STRIDE = 5
SPIN_CYCLES = 100_000_000  # ~50 ms of the card's clock ahead of the host
# phase 14: the data-parallel mapper on ranks that share the card
SHARDED_RANKS = 2
SHARDED_PAD_RANKS = 3      # 96,040 voxels are no multiple of 3
SHARDED_KEYFRAMES = 8
SHARDED_STEPS = 10         # BA steps of mapper.iters iterations
SHARDED_SITE_STEPS = 2     # then BA steps with each collective timed alone
SHARDED_ACTIVE_STEPS = 60
# tests/test_parallel.py's tolerances for the sharded production gradient:
# (rtol, atol) by optimizer group
SHARDED_GRAD_TOL = {"table": (1e-3, 2e-5), "uncert": (1e-3, 2e-5),
                    "decoder": (1e-3, 1e-5)}
SHARDED_VOL_TOL = (1e-5, 1e-6)
# collectives of one sharded BA iteration: the loss denominators and the
# gradient bucket, one all-reduce each
SHARDED_COLLECTIVES_PER_ITER = {"denominators": 1, "gradients": 1,
                                "volumes": 0, "checksum": 0}
SHARDED_TIMEOUT_S = 600
PROFILED_PLANS = 3         # aggregations traced by the profiler, at most
SOURCE = {
    "outer_scan": "naruto_tpu_torch/csrc/outer_cumsum.cu",
    "gather_rows": "naruto_tpu_torch/csrc/gather_rows.cu",
    "sorted_segment_sum": "naruto_tpu_torch/csrc/sorted_segment_sum.cu",
    "row_cumsum": "naruto_tpu_torch/csrc/row_cumsum.cu",
}
REPLACES = {
    "outer_scan": ["naruto_tpu/ops/pallas_kernels.py:57",
                   "naruto_tpu/ops/pallas_kernels.py:78"],
    "gather_rows": ["scripts/microbench_primitives.py:202",
                    "scripts/microbench_primitives.py:234",
                    "scripts/microbench_round2.py:112",
                    "scripts/microbench_round2.py:131"],
    "sorted_segment_sum": ["scripts/microbench_primitives.py:150",
                           "scripts/microbench_round2.py:165"],
    "row_cumsum": ["scripts/microbench_primitives.py:262"],
}


class BlockImports(importlib.abc.MetaPathFinder):
    """A finder that refuses to import the given top-level packages."""

    def __init__(self, names):
        self.names = tuple(names)

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in self.names:
            raise ModuleNotFoundError(f"chip_smoke blocks {name}: the port "
                                      f"imports nothing of it", name=name)
        return None


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of fn() over reps launches (CUDA events)."""
    import torch

    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def queued_ms(torch, fn, reps: int = 5) -> float:
    """Median device milliseconds of fn() by CUDA events, with the host
    ahead of the device: a spin kernel holds the stream while fn's launches
    are enqueued, so the events time the device's work and not the host's
    enqueue (fn must not synchronise)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def host_launches(torch, fn, reps: int = 3) -> float:
    """Device operations one fn() enqueues (kernel launches, copies,
    memsets), counted from the CUDA runtime calls that the profiler records
    on the host; NaN where it recorded none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events()
            if e.name.startswith(("cudaLaunch", "cuLaunch", "cudaMemcpy",
                                  "cudaMemset")))
    return n / reps if n else math.nan


def bound(nbytes: float, flops: float) -> tuple:
    """The least milliseconds the card could take for work that moves
    nbytes (each input read once, each output written once) and does flops
    f32 operations, and which of the two bounds it."""
    by_bytes, by_ops = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_F32_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


# ------------------------------------------------------------------ phase 2
def scan_inputs(torch, gen, dev, n: int, m: int, size: int, ka: int,
                kb: int) -> tuple:
    """Sorted keys of n updates in [0, size), padded to m rows with
    INT32_MAX keys and zero factors, as the hash backward pads them."""
    keys = torch.randint(0, size, (n,), generator=gen, device=dev,
                         dtype=torch.int32)
    si = torch.cat([torch.sort(keys).values,
                    torch.full((m - n,), INT32_MAX, dtype=torch.int32,
                               device=dev)])
    sa = torch.randn((m, ka), generator=gen, device=dev).bfloat16()
    sb = torch.randn((m, kb), generator=gen, device=dev).bfloat16()
    sa[n:] = 0
    sb[n:] = 0
    return si, sa, sb


def check_kernels(torch, kernels, dev) -> dict:
    """Both epilogues of the fused scan against their plain versions;
    returns, per epilogue, every case (the first is the mapping step's
    shape)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    res = {"rows": [], "slots": []}
    shapes = ((SLICE_N, SLICE_M, SLICE_SLOTS, SLICE_K, SLICE_K),) + tuple(
        (m - 37, m, m // 3, ka, kb) for m, ka, kb in SMALL_SHAPES)
    for n, m, size, ka, kb in shapes:
        si, sa, sb = scan_inputs(torch, gen, dev, n, m, size, ka, kb)
        factors = m * (ka + kb) * 2
        flops = 2 * m * ka * kb         # a multiply and an add per output
        big = m == SLICE_M
        res["rows"].append(kernel_case(
            torch, "outer_scan rows", f"M={m} {ka}x{kb}",
            lambda: kernels.outer_cumsum_scan(sa, sb),
            lambda: kernels.outer_cumsum_scan_plain(sa, sb), KERNEL_TOL,
            nbytes=factors + m * ka * kb * 4, flops=flops, profiled=big,
            deterministic=True))
        res["slots"].append(kernel_case(
            torch, "outer_scan slots", f"M={m} {ka}x{kb} -> {size} slots",
            lambda: kernels.outer_cumsum_slots(si, sa, sb, size),
            lambda: kernels.outer_cumsum_slots_plain(si, sa, sb, size),
            KERNEL_TOL, nbytes=m * 4 + factors + size * ka * kb * 4,
            flops=flops, profiled=big, deterministic=True))
    return res


# ------------------------------------------------------------------ phase 3
def check_segment_sum(torch, segment, spec, dev) -> None:
    gen = torch.Generator()
    gen.manual_seed(1)
    n, L, F = 123_359, spec.n_levels, spec.n_features
    x = torch.rand((n, 3), generator=gen)
    from naruto_tpu_torch.ops.encoding import _cell_indices, _cell_pos

    idx, _ = _cell_indices(x, spec)
    _, frac = _cell_pos(x, spec)
    g = torch.randn((n, L * F), generator=gen) * 1e-3
    size = spec.total_entries
    t0 = time.perf_counter()
    host = segment.dense_segment_sum_outer_level_major_frac(idx, frac, g,
                                                            size)
    host_s = time.perf_counter() - t0
    idx_d, frac_d, g_d = idx.to(dev), frac.to(dev), g.to(dev)
    card = segment.dense_segment_sum_outer_level_major_frac(idx_d, frac_d,
                                                            g_d, size)
    torch.cuda.synchronize()
    t0 = time.perf_counter()      # inputs already on the card: not timed
    card = segment.dense_segment_sum_outer_level_major_frac(idx_d, frac_d,
                                                            g_d, size)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    diff = float((card.cpu() - host).abs().max())
    scale = float(torch.cumsum(host, 0).abs().max())
    rel_ref = diff / float(host.abs().max())
    log(f"[segment] N={n} L={L} size={size}: max|card-host| {diff:.3e} = "
        f"{diff / scale:.3e} of max|cumsum| (tol {SEGMENT_TOL}), "
        f"{rel_ref:.3e} of max|ref|; card {card_s * 1e3:.2f} ms, host "
        f"{host_s * 1e3:.1f} ms")
    if not diff / scale <= SEGMENT_TOL:
        fail(f"segment sum differs: {diff / scale:.3e} of max|cumsum|")


def ba_points(torch, gen):
    """[BA_POINTS, 3] in [0, 1]^3: BA_SAMPLES points along each of BA_RAYS
    rays through the unit cube, crowded on few cells as the BA's are."""
    o = 0.3 + 0.4 * torch.rand((BA_RAYS, 1, 3), generator=gen)
    d = torch.nn.functional.normalize(
        torch.randn((BA_RAYS, 1, 3), generator=gen), dim=-1)
    t = torch.linspace(0.0, 0.4, BA_SAMPLES)[None, :, None]
    return (o + d * t).clamp(0.0, 1.0).reshape(-1, 3)


def check_trilinear_vjp(torch, dev) -> None:
    """The uncertainty grid's volume gradient through gather_rows and
    sorted_segment_sum on the card against the plain versions on the
    host."""
    from naruto_tpu_torch.ops.grid_sample import trilinear_sample

    gen = torch.Generator()
    gen.manual_seed(4)
    vol = torch.randn(UNCERT_SHAPE, generator=gen)
    pts = ba_points(torch, gen)
    g = torch.randn((BA_POINTS,), generator=gen)
    grads = []
    for where in ("cpu", dev):
        v = vol.to(where).requires_grad_(True)
        out = trilinear_sample(v, pts.to(where))
        grads.append(torch.autograd.grad(out, v, g.to(where))[0].cpu())
    host, card = grads
    rel = float((card - host).abs().max()) / float(host.abs().max())
    log(f"[segment] trilinear VJP, {BA_POINTS} points into "
        f"{tuple(UNCERT_SHAPE)}: max|card-host| = {rel:.3e} of max|host| "
        f"(tol {KERNEL_TOL})")
    if not rel <= KERNEL_TOL:
        fail(f"trilinear VJP differs: {rel:.3e} of max|host|")


# ------------------------------------------------------------------ phase 4
def path_pose(i: int):
    """Scripted camera path: a slow yaw sweep drifting along +x."""
    import numpy as np

    a = 0.04 * i
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.array([[math.cos(a), 0.0, math.sin(a)],
                            [0.0, 1.0, 0.0],
                            [-math.sin(a), 0.0, math.cos(a)]], np.float32)
    c2w[:3, 3] = [0.01 * i, 0.0, 0.0]
    return c2w


def count_ba_launches(kernels, mapper, per_iter: list) -> None:
    """From now on, every BA iteration of `mapper` appends to per_iter the
    launches of each kernel of the path that it made."""
    iteration = mapper._ba_iteration

    def counted(setup, draws, it):
        before = kernels.launch_counts()
        out = iteration(setup, draws, it)
        after = kernels.launch_counts()
        per_iter.append({k: after[k] - before[k]
                         for k in BA_LAUNCHES_PER_ITER})
        return out

    mapper._ba_iteration = counted


def count_track_launches(kernels, mapper, per_iter: list) -> None:
    """From now on, every tracking call of `mapper` appends to per_iter the
    launches of each kernel of the path that it made per iteration (a
    share that is not whole fails the check)."""
    track = mapper._tracking_impl

    def counted(frame_rays, init, draws):
        draws = list(draws)
        before = kernels.launch_counts()
        out = track(frame_rays, init, draws)
        after = kernels.launch_counts()
        per_iter.append({k: (after[k] - before[k]) / len(draws)
                         for k in BA_LAUNCHES_PER_ITER})
        return out

    mapper._tracking_impl = counted


def check_ba_launches(per_iter: list, want=None, what="BA") -> None:
    want = BA_LAUNCHES_PER_ITER if want is None else want
    wrong = [(i, n) for i, n in enumerate(per_iter) if n != want]
    if wrong:
        fail(f"{len(wrong)} of {len(per_iter)} {what} iterations launched "
             f"other than {want}; first: iteration {wrong[0][0]}: "
             f"{wrong[0][1]}")


def run_slice(torch, kernels, profile_dir) -> dict:
    import numpy as np

    from naruto_tpu_torch.config import make_config
    from naruto_tpu_torch.mapping.mapper import Mapper
    from naruto_tpu_torch.sim.analytic import AnalyticSimulator

    cfg = make_config("Replica", "office0")
    m = cfg.mapper
    sim = AnalyticSimulator(cfg, device="cuda")
    mapper = Mapper(cfg, device="cuda")
    per_iter = []
    count_ba_launches(kernels, mapper, per_iter)
    spec = mapper.spec.hash_spec
    log(f"[slice] office0: frames {mapper.H}x{mapper.W}, grid L"
        f"{spec.n_levels}F{spec.n_features} {spec.layout} 2^"
        f"{spec.log2_table_size} (table rows {spec.total_entries}), uncert "
        f"grid {mapper.spec.uncert_shape}, {mapper.rc.n_samples} samples/ray,"
        f" sample {m.sample}, first_iters {m.first_iters}, iters {m.iters}")
    losses = []
    first_color = first_depth = None

    kernels.reset_launch_counts()
    iters_run = 0
    torch.cuda.synchronize()
    t_all = time.perf_counter()
    vols = None
    for i in range(11):
        sim.update_step(i)
        mapper.update_step(i)
        c2w = path_pose(i)
        color = depth = None
        if mapper.needs_frame(i):
            color, depth = sim.simulate(c2w)
            if i == 0:
                first_color, first_depth = color, depth
        t0 = time.perf_counter()
        out = mapper.online_recon_step(i, color, depth, c2w)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if out is not None:
            vols = out
            n_it = m.first_iters if i == 0 else m.iters
            iters_run += n_it
            losses += [a["total"] for a in mapper.last_aux]
            counts = kernels.launch_counts()
            log(f"[slice] step {i}: {n_it} iterations in {dt:.2f} s, "
                f"launches so far "
                f"{ {k: counts[k] for k in SLICE_KERNELS} }, last loss "
                f"{float(mapper.last_aux[-1]['total']):.5f}")
            if any(counts[k] != iters_run for k in BACKWARD_KERNELS):
                fail(f"kernel launches {counts} != iterations {iters_run}: "
                     f"a mapping iteration did not run the slot-row scan "
                     f"once")
            check_ba_launches(per_iter)
    log(f"[slice] steps 0..10 in {time.perf_counter() - t_all:.2f} s")

    u, s = vols
    if tuple(u.shape) != tuple(s.shape) or tuple(u.shape) != (49, 56, 35):
        fail(f"volume shapes {tuple(u.shape)} / {tuple(s.shape)}")
    if not bool(torch.isfinite(s).all()) or not bool((u >= 0).all()):
        fail("volumes not finite or uncertainty negative")

    # the keyframe store to 22 keyframes (steady state, smallest bucket)
    render_s, n_render = 0.0, 0
    while mapper.kf.count < 22:
        fid = mapper.kf.count * m.keyframe_every
        c2w = path_pose(fid)
        sim.update_step(fid)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        color, depth = sim.simulate(c2w)
        torch.cuda.synchronize()
        render_s += time.perf_counter() - t0
        n_render += 1
        mapper.poses[fid] = torch.as_tensor(c2w, device="cuda")
        mapper.add_keyframe(mapper.frame_to_rays(color, depth), fid)
    t0 = time.perf_counter()
    mapper.map_volumes()
    torch.cuda.synchronize()
    log(f"[slice] analytic render {1e3 * render_s / n_render:.2f} ms/frame "
        f"({mapper.H}x{mapper.W}, mean of {n_render}); volume query "
        f"{1e3 * (time.perf_counter() - t0):.2f} ms "
        f"({mapper.grid01.shape[0]} points)")
    bucket = mapper._pick_bucket(mapper.kf.count)
    fid = 110
    color, depth = sim.simulate(path_pose(fid))
    frame_rays = mapper.frame_to_rays(color, depth)
    c2w_t = torch.as_tensor(path_pose(fid), device="cuda")
    for w in range(2):                      # settle, untimed
        losses += [a["total"] for a in
                   mapper._ba_impl(bucket, frame_rays, c2w_t, fid)]
    iters_run += 2 * m.iters
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for w in range(WINDOW_STEPS):
        losses += [a["total"] for a in
                   mapper._ba_impl(bucket, frame_rays, c2w_t, fid)]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    iters_run += WINDOW_STEPS * m.iters
    counts = kernels.launch_counts()
    if any(counts[k] != iters_run for k in BACKWARD_KERNELS):
        fail(f"kernel launches {counts} != iterations {iters_run}")
    check_ba_launches(per_iter)
    log(f"[slice] every one of {len(per_iter)} BA iterations launched "
        f"{BA_LAUNCHES_PER_ITER}; launches in the slice {counts}")
    its = WINDOW_STEPS * m.iters / elapsed
    rays = m.sample + bucket // 4
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[slice] BA window: {WINDOW_STEPS} steps x {m.iters} iterations in "
        f"{elapsed:.3f} s = {its:.2f} iters/s, {rays} rays/iter "
        f"(bucket {bucket}, {rays * mapper.rc.n_samples} render points + "
        f"{(cfg.training.smooth_pts - 1) ** 3} smoothness points), "
        f"keyframes {mapper.kf.count}, peak memory {peak:.2f} GiB")

    loss_t = torch.stack(losses)
    if not bool(torch.isfinite(loss_t).all()):
        fail("a loss is not finite")
    log(f"[slice] {loss_t.numel()} losses finite; first {float(loss_t[0]):.5f}"
        f", last {float(loss_t[-1]):.5f}")

    # the field learned the first view: in front of the seen surface the
    # SDF is larger than at it
    c2w0 = torch.as_tensor(path_pose(0), device="cuda")
    d = first_depth.reshape(-1)
    valid = torch.nonzero(d > 0).squeeze(1)
    pick = valid[torch.randperm(valid.numel(), device="cuda")[:4096]]
    dirs = mapper.rays_d_cam[pick] @ c2w0[:3, :3].T
    surf = c2w0[:3, 3] + dirs * d[pick, None]
    front = c2w0[:3, 3] + dirs * (0.5 * d[pick, None])
    sdf_s = mapper.predict_sdf(surf.cpu().numpy())
    sdf_f = mapper.predict_sdf(front.cpu().numpy())
    log(f"[slice] sdf (trunc units) in front of the first view's surface: "
        f"mean {sdf_f.mean():.4f}; at it: mean {sdf_s.mean():.4f}, mean |.| "
        f"{np.abs(sdf_s).mean():.4f}")
    if not sdf_f.mean() > sdf_s.mean():
        fail("the SDF in front of the first camera is not above the SDF at "
             "the surface it sees")

    if profile_dir:
        profile_step(torch, mapper, bucket, frame_rays, c2w_t, fid,
                     profile_dir)
    return {"launches": counts, "iters_per_sec": its}


def profile_step(torch, mapper, bucket, frame_rays, c2w, fid,
                 out_dir: str) -> None:
    """One BA step under torch.profiler: kernel time by name, the device's
    busy share, and launches and kernel time per iteration; the trace and
    the table go to out_dir."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        mapper._ba_impl(bucket, frame_rays, c2w, fid)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "ba_step_trace.json"))
    table = prof.key_averages().table(sort_by="self_device_time_total",
                                      row_limit=40)
    with open(os.path.join(out_dir, "ba_step_kernels.txt"), "w") as f:
        f.write(table)
    # kernels and copies only: a user annotation on the device track (the
    # optimizer's step range) spans kernels that are already counted
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.is_user_annotation)
    log(f"[profile] one BA step: wall {wall * 1e3:.1f} ms, device busy "
        f"{busy_us / 1e3:.1f} ms ({100 * busy_us / 1e3 / (wall * 1e3):.1f}% "
        f"of wall)")
    log(table)
    # launches and kernel time per iteration, kernels by launching operator
    from naruto_tpu_torch.scripts import trace_summary

    log("[profile] python -m naruto_tpu_torch.scripts.trace_summary "
        + os.path.join(out_dir, "ba_step_trace.json"))
    trace_summary.main([os.path.join(out_dir, "ba_step_trace.json"),
                        "--iters", str(mapper.cfg.mapper.iters)])


# ------------------------------------------------------------------ phase 5
def host_us(torch, fn, calls: int = HOST_CALLS) -> float:
    """The host's microseconds per fn() over `calls` calls enqueued back to
    back, with no synchronisation inside the loop (the device drains the
    queue afterwards, untimed)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    took = time.perf_counter() - t0
    torch.cuda.synchronize()
    return took / calls * 1e6


def relative_error(torch, got, ref, magnitude=None) -> float:
    """max|got - ref| / max|ref|; or, given `magnitude` (a tensor of ref's
    shape), max over elements of |got - ref| / magnitude (an element whose
    magnitude is 0 must agree exactly)."""
    if not got.numel():
        return 0.0
    diff = (got.float() - ref.float()).abs()
    if magnitude is None:
        scale = float(ref.float().abs().max())
        return float(diff.max()) / scale if scale else float(diff.max())
    mag = magnitude.float()
    exact = torch.where(diff > 0, math.inf, 0.0)
    return float(torch.where(mag > 0, diff / mag.clamp_min(1e-38),
                             exact).max())


def kernel_case(torch, name: str, shape: str, kernel, plain, tol: float,
                nbytes: float, flops: float = 0.0, library=None,
                profiled: bool = False, deterministic: bool = False,
                magnitude=None, of: str = "max|plain|") -> dict:
    """One kernel against its plain version on the same card tensors, then
    both timed: the median of PRIM_REPS CUDA-event launches, and where
    `profiled`, the device time from the profiler. `deterministic`: a
    second kernel call must give the same bits. nbytes / flops: what the
    function must move and compute, for its bound; `library`: one PyTorch
    call that computes the same function, timed beside it. The error is a
    share of max|plain|, or, where `magnitude` gives a tensor of scales
    (`of` says what they are), the largest share of an element's scale."""
    got = kernel()
    ref = plain()
    torch.cuda.synchronize()
    if got.shape != ref.shape or got.dtype != ref.dtype:
        fail(f"{name} {shape}: kernel gives {got.dtype} {tuple(got.shape)}, "
             f"plain {ref.dtype} {tuple(ref.shape)}")
    if deterministic and not torch.equal(got, kernel()):
        fail(f"{name} {shape}: two calls on the same input differ")
    abs_err = float((got.float() - ref.float()).abs().max()) \
        if got.numel() else 0.0
    rel = relative_error(torch, got, ref,
                         None if magnitude is None else magnitude())
    if not math.isfinite(rel) or rel > tol:
        fail(f"{name} {shape}: error {rel:.3e} of {of} > {tol}")
    bound_ms, bound_by = bound(nbytes, flops)
    res = {"shape": shape, "max_abs_err": abs_err, "rel_err": rel,
           "ms": cuda_ms(kernel, PRIM_REPS),
           "plain_ms": cuda_ms(plain, PRIM_REPS),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": cuda_ms(library, LIBRARY_REPS) if library else None}
    line = (f"[kernels] {name} {shape}: max|kernel-plain| {abs_err:.3e}; "
            f"{rel:.3e} of {of} (tol {tol}); kernel {res['ms']:.4f} "
            f"ms, plain {res['plain_ms']:.4f} ms (median of {PRIM_REPS})")
    if library:
        line += f", library {res['library_ms']:.4f} ms"
    line += f"; bound {bound_ms:.4f} ms ({bound_by})"
    if profiled:
        from naruto_tpu_torch.scripts.trace_summary import device_ms

        def traced(fn):
            """(device ms or None, as text): None where the tracer kept
            losing records."""
            t = device_ms(fn)
            return (None, "not measured") if math.isnan(t) else \
                (t, f"{t:.4f} ms")

        res["device_ms"], k_ms = traced(kernel)
        res["plain_device_ms"], p_ms = traced(plain)
        line += f"; device time kernel {k_ms}, plain {p_ms}"
        if library:
            res["library_device_ms"], l_ms = traced(library)
            line += f", library {l_ms}"
        line += " (profiler)"
    log(line)
    return res


def check_primitives(torch, prims, dev) -> dict:
    """gather_rows, sorted_segment_sum and row_cumsum against their plain
    versions at the scripts' sizes, at ragged M and at the BA path's
    shapes, sorted_segment_sum also on key layouts that stress its tiling;
    returns, per kernel, every case, each marked with the path whose shape
    it has ("microbenchmarks", "slice", "ragged" or "layouts")."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    res = {k: [] for k in PRIM_KERNELS}

    def case(name, path, *args, **kw):
        res[name].append({"path": path, **kernel_case(torch, name, *args,
                                                      **kw)})

    def nb(*tensors):
        return sum(t.numel() * t.element_size() for t in tensors)

    table = torch.randn((PRIM_TS, PRIM_F), generator=gen, device=dev)
    tables = (("[65536,8] bf16", table.bfloat16()),
              ("[65536,1] bf16", table[:, :1].bfloat16().contiguous()),
              ("[65536,8] f32", table))
    for m in (PRIM_M,) + RAGGED_M:
        idx = torch.randint(0, PRIM_TS, (m,), generator=gen, device=dev,
                            dtype=torch.int32)
        for label, tbl in tables:
            big = m == PRIM_M
            case("gather_rows", "microbenchmarks" if big else "ragged",
                 f"{label} x {m}", lambda: prims.gather_rows(tbl, idx),
                 lambda: prims.gather_rows_plain(tbl, idx), prims.GATHER_TOL,
                 nbytes=nb(tbl, idx) + m * nb(tbl[:1]),
                 library=(lambda: tbl.index_select(0, idx)) if big else None,
                 profiled=big)
    for label, rows, width, dtype, m, ranks in BA_GATHERS:
        tbl = torch.randn((rows, width), generator=gen, device=dev)
        tbl = (tbl * 2 ** 20).to(torch.int32) if dtype == "int32" else \
            tbl.to(getattr(torch, dtype))
        idx = torch.randint(0, rows, (m,), generator=gen, device=dev)
        if ranks:
            idx = torch.sort(idx).values
        case("gather_rows", "slice",
             f"BA {label} [{rows},{width}] {dtype} x {m} int64",
             lambda: prims.gather_rows(tbl, idx),
             lambda: prims.gather_rows_plain(tbl, idx), prims.GATHER_TOL,
             nbytes=nb(tbl, idx) + m * nb(tbl[:1]),
             library=lambda: tbl.index_select(0, idx), profiled=True)
    def segment_cases(path, label, si, vals, size, profiled, library):
        nf = vals.shape[1]
        for rb in (True, False):
            v = vals.bfloat16().float() if rb else vals
            case("sorted_segment_sum", path,
                 f"{'bf16' if rb else 'f32'} {label}{si.shape[0]} -> "
                 f"[{size},{nf}]",
                 lambda: prims.sorted_segment_sum(si, vals, size,
                                                  round_bf16=rb),
                 lambda: prims.sorted_segment_sum_plain(si, vals, size,
                                                        round_bf16=rb),
                 prims.SEGMENT_TOL, nbytes=nb(si, vals) + size * nf * 4,
                 flops=si.shape[0] * nf,
                 library=(lambda: vals.new_zeros((size, nf)).index_add_(
                     0, si, v)) if library else None,
                 profiled=profiled, deterministic=True)

    # the BA's trilinear VJP: the cells of points along rays, sorted
    from naruto_tpu_torch.ops.grid_sample import _corner_data

    cpu_gen = torch.Generator()
    cpu_gen.manual_seed(5)
    shape = torch.tensor(UNCERT_SHAPE, dtype=torch.float32)
    cells = _corner_data(UNCERT_SHAPE,
                         (ba_points(torch, cpu_gen) * shape - 0.5))[0]
    si = torch.sort(cells.to(torch.int32)).values.to(dev)
    log(f"[kernels] BA cells: {BA_POINTS} points in "
        f"{int(torch.unique(si).numel())} of {BA_CELLS} cells, longest run "
        f"{int(torch.unique_consecutive(si, return_counts=True)[1].max())}")
    segment_cases("slice", "BA cells ", si,
                  torch.randn((BA_POINTS, PRIM_F), generator=gen, device=dev),
                  BA_CELLS, True, True)
    for m in (PRIM_M,) + RAGGED_M:
        big = m == PRIM_M
        size = ((PRIM_T + 127) // 128) * 128 if big else RAGGED_SLOTS
        keys = torch.randint(0, size, (m,), generator=gen, device=dev,
                             dtype=torch.int32)
        keys[-1] = size - 1                 # the last slot is never missed
        si = torch.sort(keys).values
        vals = torch.randn((m, PRIM_F), generator=gen, device=dev)
        segment_cases("microbenchmarks" if big else "ragged", "", si, vals,
                      size, big, big)
        case("row_cumsum", "microbenchmarks" if big else "ragged",
             f"[{m},{PRIM_F}] f32", lambda: prims.row_cumsum(vals),
             lambda: prims.row_cumsum_plain(vals), prims.CUMSUM_TOL,
             nbytes=2 * nb(vals), flops=m * PRIM_F,
             library=(lambda: torch.cumsum(vals, 0)) if big else None,
             profiled=big, deterministic=True)
    for layout, m, size in SEGMENT_LAYOUTS:
        keys = torch.randint(0, size, (m,), generator=gen, device=dev,
                             dtype=torch.int32)
        if layout.startswith("one key"):
            keys[:(m * 3) // 5] = size // 3
        elif layout == "first key late":
            keys = size // 2 + keys // 2
        elif layout == "last key early":
            keys //= 3
        elif layout == "long gaps":
            keys = (keys % 3) * (size // 2 - 3) + keys % 5
        si = torch.sort(keys).values
        # long runs: small integers, whose sums are exact in any order,
        # where the plain version's atomics over many terms would drift
        vals = torch.randint(-4, 5, (m, PRIM_F), generator=gen,
                             device=dev).float() \
            if layout.startswith("one key") or layout == "long gaps" else \
            torch.randn((m, PRIM_F), generator=gen, device=dev)
        segment_cases("layouts", f"{layout}: ", si, vals, size,
                      m >= 300_000, m == PRIM_M)
    return res


def check_host_costs(torch, kernels, prims, dev) -> dict:
    """Per kernel: the host's microseconds per call of its wrapper and of
    its plain version at a small shape (HOST_CALLS calls enqueued back to
    back), where the host, not the device, sets the pace."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    m = 5000
    tbl = torch.randn((PRIM_TS, PRIM_F), generator=gen, device=dev).bfloat16()
    idx = torch.randint(0, PRIM_TS, (m,), generator=gen, device=dev,
                        dtype=torch.int32)
    si = torch.sort(torch.randint(0, RAGGED_SLOTS, (m,), generator=gen,
                                  device=dev, dtype=torch.int32)).values
    vals = torch.randn((m, PRIM_F), generator=gen, device=dev)
    ssi, sa, sb = scan_inputs(torch, gen, dev, 4571, 4608, 1536, 8, 4)
    calls = {
        "gather_rows": (f"[{PRIM_TS},{PRIM_F}] bf16 x {m}",
                        lambda: prims.gather_rows(tbl, idx),
                        lambda: prims.gather_rows_plain(tbl, idx)),
        "sorted_segment_sum": (
            f"bf16 {m} -> [{RAGGED_SLOTS},{PRIM_F}]",
            lambda: prims.sorted_segment_sum(si, vals, RAGGED_SLOTS,
                                             round_bf16=True),
            lambda: prims.sorted_segment_sum_plain(si, vals, RAGGED_SLOTS,
                                                   round_bf16=True)),
        "row_cumsum": (f"[{m},{PRIM_F}] f32",
                       lambda: prims.row_cumsum(vals),
                       lambda: prims.row_cumsum_plain(vals)),
        "outer_scan_rows": ("M=4608 8x4",
                            lambda: kernels.outer_cumsum_scan(sa, sb),
                            lambda: kernels.outer_cumsum_scan_plain(sa, sb)),
        "outer_scan_slots": (
            "M=4608 8x4 -> 1536 slots",
            lambda: kernels.outer_cumsum_slots(ssi, sa, sb, 1536),
            lambda: kernels.outer_cumsum_slots_plain(ssi, sa, sb, 1536)),
    }
    res = {}
    for name, (shape, kernel, plain) in calls.items():
        # in turns (wrapper, plain, plain, wrapper): the mean of each pair
        k1, p1, p2, k2 = (host_us(torch, fn)
                          for fn in (kernel, plain, plain, kernel))
        k_us, p_us = (k1 + k2) / 2, (p1 + p2) / 2
        res[name] = {"host_us": k_us, "plain_host_us": p_us}
        log(f"[host] {name} {shape}: wrapper {k_us:.2f} us/call ({k1:.2f}, "
            f"{k2:.2f}), plain {p_us:.2f} us/call ({p1:.2f}, {p2:.2f}); "
            f"{HOST_CALLS} calls enqueued back to back, in turns")
    return res


def run_microbenchmarks(torch, kernels) -> dict:
    """Both ported microbenchmark scripts, in this process; fails unless
    each of the three kernels was launched."""
    from naruto_tpu_torch.scripts import microbench_primitives, microbench_round2

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    log("[bench] python -m naruto_tpu_torch.scripts.microbench_primitives "
        "--quick")
    microbench_primitives.main(["--quick"])
    log("[bench] python -m naruto_tpu_torch.scripts.microbench_round2")
    microbench_round2.main([])
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    log(f"[bench] both scripts in {time.perf_counter() - t0:.2f} s, launches "
        f"{counts}")
    missing = [k for k in PRIM_KERNELS if counts[k] == 0]
    if missing:
        fail(f"the microbenchmarks never launched {missing}")
    return counts


# ------------------------------------------------------------------ phase 6
def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _gather_work(tbl, idx):
    return _nbytes(tbl, idx) + idx.shape[0] * _nbytes(tbl[:1]), 0.0


def _segment_work(si, vals, size, **_):
    return _nbytes(si, vals) + size * vals.shape[1] * 4, \
        si.shape[0] * vals.shape[1]


def _cumsum_work(x):
    return 2 * _nbytes(x), x.numel()


def _scan_rows_work(sa, sb):
    m, ka, kb = sa.shape[0], sa.shape[1], sb.shape[1]
    return _nbytes(sa, sb) + m * ka * kb * 4, 2 * m * ka * kb


def _scan_slots_work(si, sa, sb, size):
    ka, kb = sa.shape[1], sb.shape[1]
    return _nbytes(si, sa, sb) + size * ka * kb * 4, \
        2 * sa.shape[0] * ka * kb


F32_U = 2.0 ** -24         # unit roundoff of f32


def _abs_sum(torch, plain, args: list, kw: dict):
    """Each output element's sum of |terms|: the plain version on the
    inputs' absolute values (a product of bf16 factors rounds the same
    either way). The scale of an f32 sum's rounding, far above max|plain|
    where the terms cancel, as the run's gradients do."""
    return plain(*[a.abs() if isinstance(a, torch.Tensor) and
                   a.is_floating_point() else a for a in args], **kw)


def _two_orders_bound(torch, plain, args: list, kw: dict):
    """Per slot of a segment sum of n terms, 2 gamma_(n-1) x its sum of
    |terms| (gamma_k = k u / (1 - k u)): two f32 sums of the same terms in
    any orders differ by no more than this, so a larger difference is a
    fault, not rounding. A slot of one term must agree exactly."""
    si, vals, size = args
    n = plain(si, torch.ones_like(vals), size, **kw)
    k = (n - 1).clamp_min(0) * F32_U
    return 2 * k / (1 - k) * _abs_sum(torch, plain, args, kw)


class ShapeRecorder:
    """While on, every call of a kernel wrapper on card tensors is counted
    under its key (the wrapper, its tensors' shapes and dtypes, its other
    arguments), and the first call at each key keeps a copy of its inputs.
    replay() then holds the kernel against its plain version on each copy:
    every shape the run gave each kernel, on the run's own data. A sum's
    error is a share of a per-element scale (_abs_sum, _two_orders_bound):
    the run's gradients cancel. The callers reach the wrappers as module
    attributes (primitives.gather_rows, kernels.outer_cumsum_slots), so
    swapping those attributes sees every call; the wrappers themselves, and
    their launch counts, are unchanged."""

    def __init__(self, torch, kernels, prims):
        self.torch = torch
        # launch-count name: (module, attribute, plain version, tolerance,
        # bytes and operations of the function, per-element scale of the
        # error or None for max|plain|)
        self.sites = {
            "gather_rows": (prims, "gather_rows", prims.gather_rows_plain,
                            prims.GATHER_TOL, _gather_work, None),
            "sorted_segment_sum": (prims, "sorted_segment_sum",
                                   prims.sorted_segment_sum_plain, 1.0,
                                   _segment_work, _two_orders_bound),
            "row_cumsum": (prims, "row_cumsum", prims.row_cumsum_plain,
                           prims.CUMSUM_TOL, _cumsum_work, _abs_sum),
            "outer_scan_rows": (kernels, "outer_cumsum_scan",
                                kernels.outer_cumsum_scan_plain, KERNEL_TOL,
                                _scan_rows_work, _abs_sum),
            "outer_scan_slots": (kernels, "outer_cumsum_slots",
                                 kernels.outer_cumsum_slots_plain,
                                 KERNEL_TOL, _scan_slots_work, _abs_sum),
        }
        self.scale_names = {None: "max|plain|",
                            _abs_sum: "each element's sum of |terms|",
                            _two_orders_bound: "each slot's bound on two "
                                               "f32 orders"}
        self.wrappers = {name: getattr(mod, attr) for name, (mod, attr, *_)
                         in self.sites.items()}
        self.seen = {}          # key -> [name, args, kwargs, calls]

    def _recording(self, name, fn):
        torch = self.torch

        def call(*args, **kw):
            if args[0].is_cuda:
                key = (name,) + tuple(
                    (tuple(a.shape), str(a.dtype))
                    if isinstance(a, torch.Tensor) else a for a in args) \
                    + tuple(sorted(kw.items()))
                rec = self.seen.get(key)
                if rec is None:
                    rec = self.seen[key] = [name, [
                        a.detach().clone() if isinstance(a, torch.Tensor)
                        else a for a in args], kw, 0]
                rec[3] += 1
            return fn(*args, **kw)
        return call

    def __enter__(self):
        for name, (mod, attr, *_) in self.sites.items():
            setattr(mod, attr, self._recording(name, self.wrappers[name]))
        return self

    def __exit__(self, *exc):
        for name, (mod, attr, *_) in self.sites.items():
            setattr(mod, attr, self.wrappers[name])

    def replay(self, path: str) -> dict:
        """Per launch-count name, a kernel_case (marked with `path` and the
        calls at its key) for every key seen; fails on any disagreement."""
        torch = self.torch
        res = {name: [] for name in self.sites}
        for name, args, kw, calls in self.seen.values():
            _, _, plain, tol, work, scale = self.sites[name]
            kernel = self.wrappers[name]
            label = " x ".join(
                f"{list(a.shape)} {str(a.dtype).replace('torch.', '')}"
                if isinstance(a, self.torch.Tensor) else str(a)
                for a in args) + "".join(f" {k}={v}" for k, v in kw.items())
            nbytes, flops = work(*args, **kw)
            magnitude = (lambda: scale(torch, plain, args, kw)) \
                if scale else None
            f64_err = None
            if name == "sorted_segment_sum" and not kw["round_bf16"]:
                # both against the sum in f64 (logged before the check): is
                # the kernel as close to it as the plain version?
                exact = plain(args[0], args[1].double(), args[2], **kw)
                mag = _abs_sum(torch, plain, args, kw)
                f64_err = {who: relative_error(torch, out.double(), exact, mag)
                           for who, out in (("kernel", kernel(*args, **kw)),
                                            ("plain", plain(*args, **kw)))}
                log(f"[kernels] {name} {path} {label}: against the f64 sum, "
                    f"of each element's sum of |terms|: kernel "
                    f"{f64_err['kernel']:.3e}, plain {f64_err['plain']:.3e}")
            case = kernel_case(
                torch, name, f"{path} ({calls} calls) {label}",
                lambda: kernel(*args, **kw), lambda: plain(*args, **kw), tol,
                nbytes=nbytes, flops=flops, deterministic=True,
                magnitude=magnitude, of=self.scale_names[scale])
            if f64_err:
                case["f64_err"] = f64_err
            res[name].append({"path": path, "calls": calls,
                              "err_of": self.scale_names[scale], **case})
        return res


def read_row(path: str) -> dict:
    """The metric row of an eval_result.txt (its last two lines)."""
    with open(path) as f:
        header, values = f.read().strip().splitlines()[-2:]
    return dict(zip(header.split(","), map(float, values.split(","))))


def run_passive(torch, kernels, prims, root: str, tag: str = "passive",
                over=None, num_iter=None, reference=REFERENCE_ROW,
                want=None, check=None, resume_from=None) -> tuple:
    """The passive run of PASSIVE_CFG through the port's Engine, with the
    overrides `over` and `num_iter` steps (the file's 1,000 by default);
    returns the launches of each kernel over run() and finalize(), and
    every (kernel, shape) of that run held against its plain version.
    `reference`: the JAX package's row the run's row is held to (None: the
    row must be finite only); `want`: the launches of a BA iteration;
    `check(eng, row)`: further gates, called before the run's directory
    goes; `resume_from`: a full-state snapshot the run continues from.
    With tracking on, every tracking iteration must launch
    TRACK_LAUNCHES_PER_ITER."""
    import numpy as np

    from naruto_tpu_torch.config import load_config
    from naruto_tpu_torch.config.schema import deep_update
    from naruto_tpu_torch.geometry.voxel import voxel_axes
    from naruto_tpu_torch.mesh import extract, marching
    from naruto_tpu_torch.native import build
    from naruto_tpu_torch.system import engine as engine_mod

    want = BA_LAUNCHES_PER_ITER if want is None else want
    cfg = load_config(os.path.join(root, PASSIVE_CFG))
    if over:
        cfg = deep_update(cfg, over)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = deep_update(cfg, {
            "general": {"result_dir": tmp,
                        "num_iter": num_iter or cfg.general.num_iter},
            "sim": {"scene_path": os.path.join(root, cfg.sim.scene_path)}})
        m, t = cfg.mapper, cfg.training
        log(f"[{tag}] {PASSIVE_CFG}: {cfg.general.num_iter} steps, "
            f"frames {cfg.cam.H}x{cfg.cam.W}, grid L{cfg.grid.n_levels}F"
            f"{cfg.grid.n_features_per_level} {cfg.grid.layout} "
            f"{cfg.grid.table_dtype} (sort carry {cfg.grid.sort_carry}), "
            f"map_every {m.map_every}, iters {m.iters}, first_iters "
            f"{m.first_iters}, tracking {m.tracking_enable} ({m.track_iter} "
            f"iterations of {m.track_sample} rays), n_importance "
            f"{t.n_importance}, smooth_sample {t.smooth_sample}, final mesh "
            f"at {cfg.mesh.voxel_final} m")
        lib = build.lib_path("marching_tets")
        how = "found" if lib.exists() else "built with g++"
        t0 = time.perf_counter()
        marching._load_lib()
        log(f"[{tag}] marching tets: the native backend (the default; it "
            f"raises if g++ fails), {lib.name} {how} and loaded in "
            f"{time.perf_counter() - t0:.2f} s")
        eng = engine_mod.Engine(cfg, device="cuda", quiet=True)
        log(f"[{tag}] hash grid: {eng.mapper.spec.hash_spec.total_entries} "
            f"table rows, resolutions {eng.mapper.spec.hash_spec.resolutions}")
        per_iter, per_track = [], []
        count_ba_launches(kernels, eng.mapper, per_iter)
        if m.tracking_enable:
            count_track_launches(kernels, eng.mapper, per_track)
        # the gather_rows launches of each dense query (the snapshots', then
        # the final mesh's)
        gathers = []
        dense = extract._dense_sdf

        def dense_counted(*a, **kw):
            before = kernels.launch_counts()["gather_rows"]
            out = dense(*a, **kw)
            gathers.append(kernels.launch_counts()["gather_rows"] - before)
            return out

        extract._dense_sdf = dense_counted
        recorder = ShapeRecorder(torch, kernels, prims)
        try:
            with recorder:
                kernels.reset_launch_counts()
                torch.cuda.reset_peak_memory_stats()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                eng.run(resume_from=resume_from)
                torch.cuda.synchronize()
                run_s = time.perf_counter() - t0
                # the first step this run made (a resumed run's: the
                # snapshot's + 1)
                first = max(1, cfg.general.num_iter
                            - len(eng.timer.timings["SLAM"]))
                if resume_from:
                    log(f"[{tag}] resumed at step {first}: the snapshot "
                        f"loaded in "
                        f"{eng.timer.timings['full_state_load'][0]:.3f} s")
                want_iters = sum(1 for i in range(first, cfg.general.num_iter)
                                 if i % m.map_every == 0) * m.iters
                if len(per_iter) != want_iters:
                    fail(f"the run made {len(per_iter)} BA iterations, not "
                         f"{want_iters}")
                check_ba_launches(per_iter, want)
                log(f"[{tag}] run(): {len(eng.timer.timings['SLAM'])} "
                    f"steps in {run_s:.2f} s; every one of {len(per_iter)} "
                    f"BA iterations launched {want}")
                if m.tracking_enable:
                    if len(per_track) != cfg.general.num_iter - 1:
                        fail(f"{len(per_track)} tracking calls, not "
                             f"{cfg.general.num_iter - 1}")
                    check_ba_launches(per_track, TRACK_LAUNCHES_PER_ITER,
                                      "tracking")
                    log(f"[{tag}] every iteration of {len(per_track)} "
                        f"tracking calls launched {TRACK_LAUNCHES_PER_ITER}")
                peak_run = torch.cuda.max_memory_allocated() / 2 ** 30
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                eng.finalize()
                torch.cuda.synchronize()
                fin_s = time.perf_counter() - t0
                peak_fin = torch.cuda.max_memory_allocated() / 2 ** 30
        finally:
            extract._dense_sdf = dense
        counts = kernels.launch_counts()
        run_dir = os.path.join(tmp, cfg.general.dataset, cfg.general.scene)
        row = read_row(os.path.join(run_dir, "eval_result.txt"))
        n_pts = int(np.prod([len(a) for a in voxel_axes(
            np.asarray(m.marching_cubes_bound, np.float32),
            cfg.mesh.voxel_final)]))
        # the final mesh's stages are the last entries of their sections
        tm = eng.timer.timings
        stages = {k: tm[k][-1] for k in (
            "mesh_field_query", "mesh_marching_tets", "mesh_colors",
            "final_mesh", "checkpoint", "gt_mesh", "eval_mesh", "eval_mad")}
        log(f"[{tag}] finalize(): {fin_s:.2f} s; "
            + ", ".join(f"{k} {v:.2f} s" for k, v in stages.items())
            + f"; the final field query of {n_pts} points launched "
            f"gather_rows {gathers[-1]} times in chunks of "
            f"{extract.EXTRACT_CHUNK}")
        log(f"[{tag}] wall: run {run_s:.2f} s + finalize {fin_s:.2f} s = "
            f"{run_s + fin_s:.2f} s; peak device memory {peak_run:.3f} GiB "
            f"in run(), {peak_fin:.3f} GiB in finalize() (the extraction's "
            f"chunks; torch.cuda.max_memory_allocated)")
        ref = reference or {}
        log(f"[{tag}] {'metric':22s} {'port (this run)':>16s} "
            f"{'JAX package':>12s}")
        for k, v in row.items():
            log(f"[{tag}] {k:22s} {v:16.6f} "
                + (f"{ref[k]:12.6f}" if k in ref else f"{'-':>12s}"))
        if not all(math.isfinite(v) for v in row.values()):
            fail(f"a metric is not finite: {row}")
        if reference is not None:
            if not set(reference) <= set(row):
                fail(f"eval_result.txt columns {list(row)} lack "
                     f"{sorted(set(reference) - set(row))}")
            max_mad = reference["mad_cm"] + MAD_MARGIN_CM
            if abs(row["traj_length_m"] - reference["traj_length_m"]) > \
                    TRAJ_TOL:
                fail(f"traj_length_m {row['traj_length_m']} != "
                     f"{reference['traj_length_m']} within {TRAJ_TOL}")
            if row["completion_ratio_pct"] < MIN_RATIO_PCT:
                fail(f"completion_ratio_pct {row['completion_ratio_pct']} < "
                     f"{MIN_RATIO_PCT}")
            if row["mad_cm"] > max_mad:
                fail(f"mad_cm {row['mad_cm']} > {max_mad:.3f}")
        if check is not None:
            check(eng, row)
    # every (kernel, shape) of the run against its plain version, after the
    # counts were read: these launches are not the path's
    log(f"[{tag}] {len(recorder.seen)} distinct (kernel, shape) in run() "
        f"and finalize(); each against its plain version on the inputs of "
        f"its first call:")
    return counts, recorder.replay(tag)


def pose_errors(est, gt):
    """Per pose: translation error (cm) and rotation error (degrees)."""
    import numpy as np

    err = np.linalg.norm(est[:, :3, 3] - gt[:, :3, 3], axis=-1) * 100
    rel = np.einsum("nji,njk->nik", gt[:, :3, :3], est[:, :3, :3])
    ang = np.degrees(np.arccos(np.clip(
        (np.trace(rel, axis1=1, axis2=2) - 1) / 2, -1.0, 1.0)))
    return err, ang


def tracking_reach(m) -> tuple:
    """How far one tracking call can move a pose beyond its start: Adam
    moves each coordinate by at most ~lr an iteration, so track_iter * lr
    (* sqrt 3 over three coordinates): (cm, degrees)."""
    return (100 * math.sqrt(3) * m.track_iter * m.lr_trans,
            math.degrees(math.sqrt(3) * m.track_iter * m.lr_rot))


def check_tracking():
    """Phase 9's gates on the engine run's tracked trajectory: every pose
    finite. The tracked poses against data/traj_ab/traj.txt's (the poses
    the engine rendered from) are printed with the trajectory's largest
    step beside what a tracking call can move: that trajectory, the NARUTO
    planner's, turns 10 degrees in a step, beyond the reach of the schema's
    10 iterations at lr 1e-3, in either package, so the tracking gates are
    held on a path within that reach (track_path)."""
    import numpy as np

    def check(eng, row):
        m = eng.cfg.mapper
        n = eng.cfg.general.num_iter
        est = eng.mapper.poses[:n].cpu().numpy().astype(np.float64)
        gt = np.stack(eng.pose_loader.traj[:n]).astype(np.float64)
        if not np.isfinite(est).all():
            fail("a tracked pose is not finite")
        err, ang = pose_errors(est, gt)
        step_t, step_r = pose_errors(gt[1:], gt[:-1])
        reach_t, reach_r = tracking_reach(m)
        rmse = float(np.sqrt(np.mean(err ** 2)))
        log(f"[settings] every one of {n} poses finite; tracked against "
            f"data/traj_ab/traj.txt: translation RMSE {rmse:.3f} cm, worst "
            f"{err.max():.3f} cm (frame {int(err.argmax())}), mean "
            f"{err.mean():.3f} cm; rotation error mean {ang.mean():.4f} deg, "
            f"worst {ang.max():.4f} deg; trajectory {row['traj_length_m']:.6f}"
            f" m tracked. The trajectory's steps: up to {step_t.max():.3f} "
            f"cm and {step_r.max():.3f} deg ({int((step_r > reach_r).sum())}"
            f" of {n - 1} turn more than a tracking call's reach of "
            f"{reach_r:.3f} deg, {reach_t:.3f} cm: {m.track_iter} "
            f"iterations at lr {m.lr_rot}/{m.lr_trans}); first such step "
            f"{int(np.argmax(step_r > reach_r)) + 1}, first frame off by "
            f"> 10 cm {int(np.argmax(err > 10))}")
    return check


def track_path_pose(i: int, step_cm: float, step_deg: float):
    """A path of constant speed: a yaw of step_deg and step_cm along +x a
    step (phase 4's path, slowed to a tracking call's reach)."""
    import numpy as np

    a = math.radians(step_deg) * i
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.array([[math.cos(a), 0.0, math.sin(a)],
                            [0.0, 1.0, 0.0],
                            [-math.sin(a), 0.0, math.cos(a)]], np.float32)
    c2w[:3, 3] = [0.01 * step_cm * i, 0.0, 0.0]
    return c2w


def track_path(torch, kernels) -> None:
    """Phase 9's tracking gates: the mapper with phase 9's settings, frames
    of the analytic office0 room rendered along track_path_pose at half a
    tracking call's reach a step, TRACK_PATH_STEPS steps through
    online_recon_step (tracking every frame from the constant-speed start,
    BA with pose optimisation every map_every): the tracked translations
    within MAX_TRACK_RMSE_CM (RMSE) and MAX_TRACK_ERR_CM (worst frame) of
    the path's. A tracker that returned its start would be off by one step
    a frame from frame 1 on (TRACK_PATH_STEPS half-reaches at the end)."""
    import numpy as np

    from naruto_tpu_torch.config import make_config
    from naruto_tpu_torch.mapping.mapper import Mapper
    from naruto_tpu_torch.sim.analytic import AnalyticSimulator

    cfg = make_config("Replica", "office0", overrides=SETTINGS_OVER)
    m = cfg.mapper
    reach_cm, reach_deg = tracking_reach(m)
    step_cm, step_deg = 0.5 * reach_cm / math.sqrt(3), \
        0.5 * reach_deg / math.sqrt(3)
    sim = AnalyticSimulator(cfg, device="cuda")
    mapper = Mapper(cfg, device="cuda")
    per_track = []
    count_track_launches(kernels, mapper, per_track)
    gt = [track_path_pose(i, step_cm, step_deg)
          for i in range(TRACK_PATH_STEPS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, c2w in enumerate(gt):
        sim.update_step(i)
        mapper.update_step(i)
        color, depth = sim.simulate(c2w)
        mapper.online_recon_step(i, color, depth, c2w)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_ba_launches(per_track, TRACK_LAUNCHES_PER_ITER, "tracking")
    est = mapper.poses[:TRACK_PATH_STEPS].cpu().numpy().astype(np.float64)
    if not np.isfinite(est).all():
        fail("a tracked pose of the path is not finite")
    err, ang = pose_errors(est, np.stack(gt).astype(np.float64))
    rmse = float(np.sqrt(np.mean(err ** 2)))
    log(f"[track path] {TRACK_PATH_STEPS} steps of {step_cm:.3f} cm and "
        f"{step_deg:.4f} deg (half a tracking call's reach) through "
        f"online_recon_step in {wall:.2f} s, frames {mapper.H}x{mapper.W}: "
        f"translation RMSE {rmse:.3f} cm, worst {err.max():.3f} cm (frame "
        f"{int(err.argmax())}); rotation error mean {ang.mean():.4f} deg, "
        f"worst {ang.max():.4f} deg; a tracker that kept its start would be "
        f"{step_cm * (TRACK_PATH_STEPS - 1):.2f} cm off at the end")
    if rmse > MAX_TRACK_RMSE_CM:
        fail(f"tracked translation RMSE {rmse:.3f} cm > {MAX_TRACK_RMSE_CM} "
             f"cm on the path")
    if err.max() > MAX_TRACK_ERR_CM:
        fail(f"tracked translation error {err.max():.3f} cm > "
             f"{MAX_TRACK_ERR_CM} cm at frame {int(err.argmax())} of the "
             f"path")


# ------------------------------------------------------------------ phase 7
def run_active(torch, kernels, prims, root: str, tag: str = "active",
               over=None, seed: int = ACTIVE_SEED,
               jax_rows: str = JAX_ACTIVE_ROWS, hook=None,
               check=None) -> tuple:
    """The active 2,000-step run of ACTIVE_CFG (with the overrides `over`,
    at `seed`) through the port's Engine; returns the launches of each
    kernel over run() and finalize(), and every (kernel, shape) of that run
    held against its plain version. `jax_rows`: the JAX package's rows of
    JAX_ACTIVE_SEEDS printed beside the row; `hook(eng)`: called on the new
    Engine before the run; `check(eng, row, summary)`: further gates,
    called before the run's directory goes."""
    import numpy as np

    from naruto_tpu_torch.config import load_config
    from naruto_tpu_torch.config.schema import deep_update
    from naruto_tpu_torch.scripts.trace_summary import device_profile
    from naruto_tpu_torch.system import engine as engine_mod

    jax_rows = {s: read_row(os.path.join(root, jax_rows.format(s)))
                for s in JAX_ACTIVE_SEEDS}
    cfg = load_config(os.path.join(root, ACTIVE_CFG))
    if over:
        cfg = deep_update(cfg, over)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = deep_update(cfg, {"general": {"result_dir": tmp,
                                            "seed": seed}})
        m = cfg.mapper
        eng = engine_mod.Engine(cfg, device="cuda", quiet=True)
        planner = eng.planner
        log(f"[{tag}] {ACTIVE_CFG}: {cfg.general.num_iter} steps, seed "
            f"{cfg.general.seed}, frames {cfg.cam.H}x{cfg.cam.W}, grid L"
            f"{cfg.grid.n_levels}F{cfg.grid.n_features_per_level} "
            f"{cfg.grid.layout}, map_every {m.map_every}, iters {m.iters}; "
            f"planner volume {planner.vol_shape}, goal space "
            f"{planner.goal_space.shape} ({len(planner.goal_space.points)} "
            f"goals, chunks of {planner.aggregate.chunk}), top-k "
            f"{planner.aggregate.k_eff}, subset {planner.aggregate.subset_eff}"
            f", RRT max_iter {planner.local_planner.max_iter}")
        if hook is not None:
            hook(eng)
        per_iter = []
        count_ba_launches(kernels, eng.mapper, per_iter)
        # per plan: each aggregation timed by CUDA events in the run (its
        # inputs and draw kept for the profiler after it), the RRT's host
        # time (path planning, and the traversability mask's dense growth)
        aggs, rrts = [], []
        aggregate = planner.aggregate
        path_planning = planner.path_planning
        trav_mask = planner.compute_traversability_mask

        def timed_aggregate(uncert, sdf, sel):
            drawn = []

            def draw(top_vals):
                drawn.append(sel(top_vals))
                return drawn[0]

            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = aggregate(uncert, sdf, draw)
            b.record()
            b.synchronize()
            aggs.append({"step": planner.step, "ms": a.elapsed_time(b),
                         "args": (uncert, sdf, drawn[0])})
            return out

        timed_aggregate.draw_subset = aggregate.draw_subset

        def host_timed(fn, kind):
            def call(*args):
                t0 = time.perf_counter()
                out = fn(*args)
                rrts.append({"step": planner.step, "kind": kind,
                             "s": time.perf_counter() - t0})
                return out
            return call

        planner.aggregate = timed_aggregate
        planner.path_planning = host_timed(path_planning, "path")
        planner.compute_traversability_mask = host_timed(trav_mask, "mask")
        recorder = ShapeRecorder(torch, kernels, prims)
        with recorder:
            kernels.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.run()
            torch.cuda.synchronize()
            run_s = eng.run_seconds = time.perf_counter() - t0
            want_iters = sum(1 for i in range(1, cfg.general.num_iter)
                             if i % m.map_every == 0) * m.iters
            if len(per_iter) != want_iters:
                fail(f"the active run made {len(per_iter)} BA iterations, "
                     f"not {want_iters}")
            check_ba_launches(per_iter)
            log(f"[{tag}] run(): {cfg.general.num_iter} steps in "
                f"{run_s:.2f} s; every one of {len(per_iter)} BA iterations "
                f"launched {BA_LAUNCHES_PER_ITER}")
            t0 = time.perf_counter()
            eng.finalize()
            torch.cuda.synchronize()
            fin_s = time.perf_counter() - t0
        counts = kernels.launch_counts()
        run_dir = os.path.join(tmp, cfg.general.dataset, cfg.general.scene)
        row = read_row(os.path.join(run_dir, "eval_result.txt"))
        with open(os.path.join(run_dir, "planner_stats.json")) as f:
            stats = json.load(f)
        if check is not None:
            check(eng, row, stats["summary"])
    summary, events = stats["summary"], stats["events"]
    log(f"[{tag}] wall: run {run_s:.2f} s + finalize {fin_s:.2f} s = "
        f"{run_s + fin_s:.2f} s (the timer sections: the table above); "
        f"peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
    log(f"[{tag}] stats_summary(): {json.dumps(summary)}")

    # per plan: the aggregation's device time on the run's own inputs,
    # after the run (the port's kernels are not among its launches): by
    # CUDA events with the host ahead of the device, and by the profiler,
    # which in this process loses device records; its launches are counted
    # from the host's CUDA runtime calls, which it keeps
    profiled = tried = 0
    for a in aggs:
        uncert, sdf, sel = a["args"]

        def call():
            return aggregate(uncert, sdf, sel)

        a["device_ms"] = queued_ms(torch, call, reps=3)
        a["launches"] = host_launches(torch, call)
        a["profiled_ms"] = math.nan
        if profiled < PROFILED_PLANS and tried < 4 * PROFILED_PLANS:
            a["profiled_ms"] = device_profile(call, reps=3, tries=2)[0]
            profiled += math.isfinite(a["profiled_ms"])
            tried += 1
    for k, ev in enumerate(events):
        mine = [a for a in aggs if a["step"] == ev["step"]]
        rrt = {r["kind"]: r["s"] for r in rrts if r["step"] == ev["step"]}
        log(f"[{tag}] plan {k} at step {ev['step']}: goal {ev['goal_vxl']}"
            f" from {ev['pos_vxl']}, reachable {ev['reachable']}, path "
            f"{ev['path_len']} nodes; aggregation "
            + ", ".join(f"events {a['ms']:.3f} ms, device "
                        f"{a['device_ms']:.3f} ms in {a['launches']:.0f} "
                        f"launches" + (
                            f" (profiler {a['profiled_ms']:.3f} ms)"
                            if math.isfinite(a["profiled_ms"]) else "")
                        for a in mine)
            + f"; RRT host {1e3 * rrt.get('path', math.nan):.1f} ms"
            + (f" (+ traversability mask {1e3 * rrt['mask']:.1f} ms)"
               if "mask" in rrt else ""))

    def spread(vals, unit, scale=1.0):
        if not vals:
            return "none"
        vals = [v * scale for v in vals if math.isfinite(v)]
        if not vals:
            return "not measured"
        return (f"median {float(np.median(vals)):.3f} {unit} (min "
                f"{min(vals):.3f}, max {max(vals):.3f}, total "
                f"{sum(vals):.3f})")

    log(f"[{tag}] {len(events)} plans, {len(aggs)} aggregations: events "
        f"in the run {spread([a['ms'] for a in aggs], 'ms')}; device "
        f"{spread([a['device_ms'] for a in aggs], 'ms')}; profiler "
        f"{spread([a['profiled_ms'] for a in aggs], 'ms')}, launches "
        f"{spread([a['launches'] for a in aggs], '')}; RRT host "
        f"{spread([r['s'] for r in rrts if r['kind'] == 'path'], 'ms', 1e3)}"
        f"; traversability masks "
        f"{spread([r['s'] for r in rrts if r['kind'] == 'mask'], 'ms', 1e3)}")
    log(f"[{tag}] {'metric':22s} {'port (this run)':>16s} "
        f"{'JAX, 5 seeds: min-max':>23s} {'mean':>10s}")
    for k in row:
        ref = [r[k] for r in jax_rows.values() if k in r]
        band = f"{min(ref):.6f}-{max(ref):.6f}" if ref else "not recorded"
        mean = f"{sum(ref) / len(ref):10.6f}" if ref else ""
        log(f"[{tag}] {k:22s} {row[k]:16.6f} {band:>23s} {mean}")

    if not all(math.isfinite(v) for v in row.values()):
        fail(f"a metric of the active run is not finite: {row}")
    missing = [s for s in FSM_STATES if not summary["state_steps"].get(s)]
    if missing:
        fail(f"the planner never entered {missing}")
    checks = (
        (summary["n_plans"] >= MIN_PLANS,
         f"{summary['n_plans']} plans < {MIN_PLANS}"),
        (row["traj_length_m"] >= MIN_TRAJ_M,
         f"traj_length_m {row['traj_length_m']} < {MIN_TRAJ_M}"),
        (row["completion_ratio_pct"] >= MIN_ACTIVE_RATIO_PCT,
         f"completion_ratio_pct {row['completion_ratio_pct']} < "
         f"{MIN_ACTIVE_RATIO_PCT}"),
        (row["mad_cm"] <= MAX_ACTIVE_MAD_CM,
         f"mad_cm {row['mad_cm']} > {MAX_ACTIVE_MAD_CM}"),
        (row["accuracy_cm"] <= MAX_ACTIVE_ACC_CM,
         f"accuracy_cm {row['accuracy_cm']} > {MAX_ACTIVE_ACC_CM}"),
        (row["completion_cm"] <= MAX_ACTIVE_COMP_CM,
         f"completion_cm {row['completion_cm']} > {MAX_ACTIVE_COMP_CM}"))
    for ok, msg in checks:
        if not ok:
            fail(f"{tag} run: {msg}")
    log(f"[{tag}] {len(recorder.seen)} distinct (kernel, shape) in run() "
        f"and finalize(); each against its plain version on the inputs of "
        f"its first call:")
    return counts, recorder.replay(tag)


# -------------------------------------------------------------- phase 10
def check_renderer(torch, cfg, sim, poses) -> None:
    """The raycast renderer on the mesh against the analytic scene the mesh
    was made from, at `poses`: the median |depth difference| over pixels
    valid in both within half of mesh.voxel_eval, the ERP probe's closest
    distance within mesh.voxel_eval, and two renders of a pose equal bit for
    bit (OpenMP's schedule changes no pixel)."""
    import numpy as np

    from naruto_tpu_torch.sim.analytic import AnalyticSimulator

    analytic = AnalyticSimulator(cfg, "cuda")
    vs = cfg.mesh.voxel_eval
    for k, c2w in enumerate(poses):
        color, depth = sim.render_host(c2w)
        again = sim.render_host(c2w)
        if not (np.array_equal(color, again[0])
                and np.array_equal(depth, again[1])):
            fail(f"two raycast renders of pose {k} differ")
        ref = analytic.simulate(c2w)[1].cpu().numpy()
        both = (depth > 0) & (ref > 0)
        if not both.any():
            fail(f"pose {k}: no pixel valid in both renders")
        diff = np.abs(depth - ref)[both]
        med, p99 = float(np.median(diff)), float(np.percentile(diff, 99))
        t0 = time.perf_counter()
        probe = sim.probe_erp_dist(c2w)
        probe_ms = 1e3 * (time.perf_counter() - t0)
        ref_probe = analytic.probe_erp_dist(c2w).cpu().numpy()
        dmin = abs(float(probe.min()) - float(ref_probe.min()))
        log(f"[raycast] pose {k}: depth |mesh - analytic| over "
            f"{100 * both.mean():.2f}% of pixels valid in both: median "
            f"{100 * med:.4f} cm, 99th percentile {100 * p99:.4f} cm; ERP "
            f"probe {probe.shape[0]}x{probe.shape[1]} closest "
            f"{probe.min():.4f} m (analytic {ref_probe.min():.4f} m, "
            f"|diff| {100 * dmin:.4f} cm), invalid share "
            f"{(probe > 1e6).mean():.4f} (analytic "
            f"{(ref_probe > 1e6).mean():.4f}), probe {probe_ms:.2f} ms on "
            f"the host; two renders equal bit for bit")
        if med > vs / 2:
            fail(f"pose {k}: median depth difference {med:.4f} m > "
                 f"{vs / 2} m (half of mesh.voxel_eval)")
        if dmin > vs:
            fail(f"pose {k}: probe's closest distance differs by "
                 f"{dmin:.4f} m > {vs} m")


def run_raycast(torch, kernels, prims, root: str, keep_dir: str) -> tuple:
    """Phase 10: office0's analytic room synthesised as a mesh at
    mesh.voxel_eval (the port's scripts/make_scene_assets.py), then phase
    7's run on it through the raycast simulator, writing its snapshot at
    RAYCAST_SNAPSHOT_STEP (kept in keep_dir for phase 11). Returns the
    launches, the replayed cases and what phase 11 needs."""
    import numpy as np

    from naruto_tpu_torch.config import load_config
    from naruto_tpu_torch.scripts.make_scene_assets import (make_scene_mesh,
                                                            write_scene_mesh)

    cfg = load_config(os.path.join(root, ACTIVE_CFG))
    vs = cfg.mesh.voxel_eval
    t0 = time.perf_counter()
    verts, faces, colors = make_scene_mesh(cfg.general.dataset,
                                           cfg.general.scene, vs, "cuda")
    mesh = os.path.join(keep_dir, f"{cfg.general.scene}_mesh.ply")
    write_scene_mesh(mesh, verts, faces, colors)
    log(f"[raycast] scene: {cfg.general.dataset}/{cfg.general.scene}'s "
        f"analytic room as a mesh at {vs} m "
        f"(naruto_tpu_torch/scripts/make_scene_assets.py): {len(verts)} "
        f"vertices, {len(faces)} faces, "
        f"{os.path.getsize(mesh) / 2 ** 20:.2f} MiB, made in "
        f"{time.perf_counter() - t0:.2f} s")
    rendered, info = [], {}

    def hook(eng):
        frame = eng.sim.frame

        def recorded(c2w):
            if len(rendered) < RENDER_CHECK_POSES:
                rendered.append(np.array(c2w, np.float32))
            return frame(c2w)

        eng.sim.frame = recorded
        log(f"[raycast] {type(eng.sim).__name__}: a BVH over "
            f"{eng.sim.n_faces} faces on the host, OpenMP on "
            f"{os.cpu_count()} cores; the ground truth at finalize(): the "
            f"scene_path mesh (not the analytic surface)")

    def check(eng, row, summary):
        t = eng.timer.timings
        renders = t["Simulation"]
        H, W = eng.cfg.sim.pinhole_hw
        log(f"[raycast] frames: {len(renders)} renders of {H}x{W}, "
            f"{1e3 * sum(renders) / len(renders):.2f} ms a frame on the "
            f"host (median {1e3 * float(np.median(renders)):.2f} ms, quantized "
            f"there and copied as uint8); the Simulation section "
            f"{sum(renders):.2f} s; ERP probes {summary['n_probes']} "
            f"({summary['probe_wall_s']} s)")
        check_renderer(torch, eng.cfg, eng.sim, rendered)
        snap = os.path.join(keep_dir, "raycast_full_state.pkl")
        shutil.copyfile(eng.snapshot_path(), snap)
        info.update(snapshot=snap, cfg=eng.cfg,
                    poses=eng.mapper.poses.cpu().clone(),
                    save_s=t["full_state_save"])

    over = {"sim": {"method": "raycast", "scene_path": mesh},
            "general": {"ckpt_freq": RAYCAST_SNAPSHOT_STEP}}
    counts, cases = run_active(torch, kernels, prims, root, "raycast", over,
                               RAYCAST_SEED, JAX_RAYCAST_ROWS, hook, check)
    log(f"[raycast] snapshot at step {RAYCAST_SNAPSHOT_STEP}: "
        f"{os.path.getsize(info['snapshot']) / 2 ** 20:.1f} MiB written in "
        f"{info['save_s'][0]:.3f} s")
    return counts, cases, info


# -------------------------------------------------------------- phase 11
class StopRun(Exception):
    """Ends a resumed run early (raised from a wrapped planner step)."""


def run_resumed_active(torch, kernels, prims, info: dict) -> tuple:
    """Phase 11, active: a fresh Engine on phase 10's configuration resumes
    from its mid-run snapshot and runs until RESUME_STEPS_AFTER_RRT steps
    after the RRT first draws from its host rng (which no snapshot
    restores). Its poses must be phase 10's, bit for bit, up to that draw;
    the step where the two part is printed. Returns the launches and the
    replayed cases."""
    from naruto_tpu_torch.config.schema import deep_update
    from naruto_tpu_torch.system import engine as engine_mod

    with tempfile.TemporaryDirectory() as tmp:
        cfg = deep_update(info["cfg"], {"general": {"result_dir": tmp,
                                                    "ckpt_freq": 0}})
        eng = engine_mod.Engine(cfg, device="cuda", quiet=True)
        planner = eng.planner
        per_iter, first_rrt = [], []
        count_ba_launches(kernels, eng.mapper, per_iter)
        for name in ("run", "run_full"):
            fn = getattr(planner.local_planner, name)

            def drawn(*a, _fn=fn, **kw):
                first_rrt.append(planner.step)
                return _fn(*a, **kw)

            setattr(planner.local_planner, name, drawn)
        step = planner.main

        def stepped(vols, c2w, new_vols):
            out = step(vols, c2w, new_vols)
            if first_rrt and planner.step >= first_rrt[0] + \
                    RESUME_STEPS_AFTER_RRT:
                raise StopRun
            return out

        planner.main = stepped
        recorder = ShapeRecorder(torch, kernels, prims)
        with recorder:
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                eng.run(resume_from=info["snapshot"])
            except StopRun:
                pass
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
        counts = kernels.launch_counts()
    start, last = RAYCAST_SNAPSHOT_STEP + 1, eng.mapper.step
    check_ba_launches(per_iter)
    got = eng.mapper.poses[:last + 1].cpu()
    want = info["poses"][:last + 1]
    parted = [i for i in range(last + 1) if not torch.equal(got[i], want[i])]
    upto = first_rrt[0] if first_rrt else last
    log(f"[resumed] active: resumed at step {start} (snapshot loaded in "
        f"{eng.timer.timings['full_state_load'][0]:.3f} s), steps "
        f"{start}-{last} in {run_s:.2f} s, {len(per_iter)} BA iterations "
        f"each launching {BA_LAUNCHES_PER_ITER}; the RRT first drew at step "
        + (f"{first_rrt[0]}" if first_rrt else "- (never)")
        + "; poses equal to phase 10's bit for bit "
        + (f"up to step {parted[0] - 1}, parting at step {parted[0]}"
           if parted else f"through step {last}"))
    if parted and parted[0] <= upto:
        fail(f"the resumed active run parted from phase 10's at step "
             f"{parted[0]}, before the RRT's first draw (step {upto})")
    if not per_iter:
        fail("the resumed active run made no BA iteration")
    return counts, recorder.replay("resumed")


# -------------------------------------------------------------- phase 12
def _median_ms(fn, reps: int = CODEC_REPS) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return sorted(times)[len(times) // 2]


def check_codec(torch, frame, depth_trunc: float) -> dict:
    """The codec's contracts at the frame's size (the card machine has no
    cv2 to compare with): PNG round trips exact, a JPEG round trip within
    CODEC_MIN_PSNR_DB, jet equal to matplotlib's pinned values; returns
    the codec's ms (host medians of CODEC_REPS calls), the saver's rgbd
    panel of this frame (RGB | jet depth) among them."""
    import numpy as np

    from naruto_tpu_torch.native import build
    from naruto_tpu_torch.sim.base import truncate_color
    from naruto_tpu_torch.utils import image_io
    from naruto_tpu_torch.visualization import raster
    from naruto_tpu_torch.visualization.saver import rgbd_panel

    lib = build.lib_path("image_codec")
    how = "found" if lib.exists() else "built with g++"
    t0 = time.perf_counter()
    image_io._lib()
    log(f"[codec] {lib.name} {how} and loaded in "
        f"{time.perf_counter() - t0:.2f} s")
    color, depth = (x.cpu().numpy() for x in frame)
    rgb = truncate_color(color)
    d16 = np.clip(depth * 6553.5, 0, 65535).astype(np.uint16)
    png8, png16 = image_io.encode_png(rgb), image_io.encode_png(d16)
    if not np.array_equal(image_io.decode_png(png8), rgb):
        fail("the uint8 PNG round trip is not exact")
    if not np.array_equal(image_io.decode_png(png16), d16):
        fail("the uint16 PNG round trip is not exact")
    jpg = image_io.encode_jpeg(rgb)
    back = image_io.decode_jpeg(jpg)
    if back.shape != rgb.shape:
        fail(f"the JPEG round trip gave {back.shape}, not {rgb.shape}")
    mse = float(np.mean((back.astype(np.float64) - rgb) ** 2))
    psnr = 10 * math.log10(255.0 ** 2 / max(mse, 1e-12))
    if psnr < CODEC_MIN_PSNR_DB:
        fail(f"JPEG round trip at {psnr:.2f} dB < {CODEC_MIN_PSNR_DB}")
    for i, want in JET_PINNED.items():
        got = tuple(float(v) for v in raster.JET_LUT[i])
        if got != want:
            fail(f"jet[{i}] = {got}, matplotlib's is {want}")
    panel = rgbd_panel(color, depth, depth_trunc)
    png_panel = image_io.encode_png(panel)
    if not np.array_equal(image_io.decode_png(png_panel), panel):
        fail("the rgbd panel's PNG round trip is not exact")
    ms = {"jpeg_decode": _median_ms(lambda: image_io.decode_jpeg(jpg)),
          "jpeg_encode": _median_ms(lambda: image_io.encode_jpeg(rgb)),
          "png16_decode": _median_ms(lambda: image_io.decode_png(png16)),
          "png16_encode": _median_ms(lambda: image_io.encode_png(d16)),
          "rgbd_panel": _median_ms(
              lambda: rgbd_panel(color, depth, depth_trunc), 3),
          "panel_png_encode": _median_ms(lambda: image_io.encode_png(panel),
                                         3)}
    h, w = rgb.shape[:2]
    log(f"[codec] {h}x{w}: PNG uint8 ({len(png8)} B) and uint16 "
        f"({len(png16)} B) round trips exact; JPEG q95 4:2:0 {len(jpg)} B "
        f"at {psnr:.2f} dB PSNR (>= {CODEC_MIN_PSNR_DB}); jet equals "
        f"matplotlib's {len(JET_PINNED)} pinned entries")
    log("[codec] host ms (median of "
        f"{CODEC_REPS}): " + ", ".join(f"{k} {v:.2f}" for k, v in ms.items())
        + f" (the saver's rgbd panel, {h}x{2 * w} RGB | jet depth, "
        f"{len(png_panel)} B as a PNG)")
    return ms


def run_replay(torch, kernels, prims, root: str) -> tuple:
    """Phase 12: the codec's contracts, the capture of REPLAY_STEPS poses,
    and the passive run on the analytic simulator and over their replay.
    Returns the replayed run's launches and cases."""
    import numpy as np

    from naruto_tpu_torch.config import load_config
    from naruto_tpu_torch.config.schema import deep_update
    from naruto_tpu_torch.sim.analytic import AnalyticSimulator
    from naruto_tpu_torch.sim.replay import ReplaySimulator
    from naruto_tpu_torch.sim.scripted import run_scripted_simulation
    from naruto_tpu_torch.system.pose_loader import load_traj_file

    cfg = load_config(os.path.join(root, PASSIVE_CFG))
    traj = os.path.join(root, cfg.sim.scene_path, "traj.txt")
    poses = load_traj_file(traj, cfg.general.dataset)[:REPLAY_STEPS]
    sim = AnalyticSimulator(cfg, "cuda")
    codec_ms = check_codec(torch, sim.simulate(poses[0]),
                           cfg.cam.depth_trunc)
    with tempfile.TemporaryDirectory(prefix="replay_") as cap:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_scripted_simulation(sim, poses, cap,
                                depth_scale=cfg.cam.png_depth_scale)
        capture_s = time.perf_counter() - t0
        res = os.path.join(cap, "results")
        size = sum(os.path.getsize(os.path.join(res, f))
                   for f in os.listdir(res))
        # a render alone, for the split of the capture's time
        render_ms = _median_ms(lambda: [x.cpu() for x in sim.simulate(
            poses[1])])
        cfg_r = deep_update(cfg, {"sim": {"method": "replay",
                                          "scene_path": cap}})
        replay_sim = ReplaySimulator(cfg_r, "cuda")

        def replay_frame():
            replay_sim.update_step(1)
            replay_sim.frame(poses[1])
            torch.cuda.synchronize()

        replay_ms = _median_ms(replay_frame)
        log(f"[replay] captured {len(poses)} poses of {traj} at "
            f"{cfg.cam.H}x{cfg.cam.W}: {1e3 * capture_s / len(poses):.2f} "
            f"ms a frame (render {render_ms:.2f} ms + encode and write), "
            f"{size / 2 ** 20:.1f} MiB; a replayed frame (decode + copy to "
            f"the card) {replay_ms:.2f} ms")
        ref = {}

        def keep_analytic(eng, row):
            run_dir = os.path.join(eng.cfg.general.result_dir,
                                   eng.cfg.general.dataset,
                                   eng.cfg.general.scene)
            shutil.copyfile(os.path.join(run_dir, "gt_mesh.ply"),
                            os.path.join(cap, "mesh.ply"))
            ref.update(row=row, poses=eng.mapper.poses[:REPLAY_STEPS].cpu(),
                       wall=sum(eng.timer.timings["SLAM"]))

        t0 = time.perf_counter()
        run_passive(torch, kernels, prims, root, "replay-analytic",
                    num_iter=REPLAY_STEPS, reference=None,
                    check=keep_analytic)
        analytic_s = time.perf_counter() - t0

        def same_as_analytic(eng, row):
            poses_r = eng.mapper.poses[:REPLAY_STEPS].cpu()
            err = float((poses_r - ref["poses"]).abs().max())
            if err > TRAJ_TOL:
                fail(f"the replayed poses are {err} from the analytic "
                     f"run's (> {TRAJ_TOL})")
            d_ratio = abs(row["completion_ratio_pct"]
                          - ref["row"]["completion_ratio_pct"])
            d_mad = abs(row["mad_cm"] - ref["row"]["mad_cm"])
            log(f"[replay] {'metric':22s} {'replayed':>12s} "
                f"{'analytic':>12s}")
            for k, v in row.items():
                log(f"[replay] {k:22s} {v:12.6f} {ref['row'][k]:12.6f}")
            if d_ratio > REPLAY_RATIO_PTS:
                fail(f"the replayed ratio is {d_ratio:.4f} points from the "
                     f"analytic run's (> {REPLAY_RATIO_PTS})")
            if d_mad > REPLAY_MAD_CM:
                fail(f"the replayed MAD is {d_mad:.4f} cm from the analytic "
                     f"run's (> {REPLAY_MAD_CM})")
            log(f"[replay] poses within {err:.3g} m of the analytic run's "
                f"(<= {TRAJ_TOL}); ratio {d_ratio:.4f} points (<= "
                f"{REPLAY_RATIO_PTS}) and MAD {d_mad:.4f} cm (<= "
                f"{REPLAY_MAD_CM}) from it")

        t0 = time.perf_counter()
        counts, cases = run_passive(
            torch, kernels, prims, root, "replay",
            over={"sim": {"method": "replay", "scene_path": cap}},
            num_iter=REPLAY_STEPS, reference=None, check=same_as_analytic)
        replay_s = time.perf_counter() - t0
    log(f"[replay] wall (run, finalize and replays): analytic "
        f"{analytic_s:.2f} s, replayed {replay_s:.2f} s; capture "
        f"{capture_s:.2f} s")
    return counts, cases, {"codec_ms": codec_ms,
                           "capture_ms": 1e3 * capture_s / len(poses),
                           "render_ms": render_ms, "replay_ms": replay_ms}


# -------------------------------------------------------------- phase 13
def run_vis(torch, kernels, prims, root: str, phase7: dict) -> tuple:
    """Phase 13: phase 7's run for VIS_STEPS steps with the artifact saver,
    the offline tools on its artifacts and export_pose on its checkpoint.
    Returns the launches and the replayed cases."""
    import glob

    import numpy as np

    from naruto_tpu_torch import export_pose
    from naruto_tpu_torch.config import load_config
    from naruto_tpu_torch.config.schema import deep_update
    from naruto_tpu_torch.mesh.ply import read_ply
    from naruto_tpu_torch.system import engine as engine_mod
    from naruto_tpu_torch.utils.image_io import read_avi_frames, read_png
    from naruto_tpu_torch.visualization import offline, raster

    cfg = load_config(os.path.join(root, ACTIVE_CFG))
    with tempfile.TemporaryDirectory(prefix="vis_") as tmp:
        cfg = deep_update(cfg, {
            "general": {"result_dir": tmp, "seed": ACTIVE_SEED},
            "vis": {"enable_all_vis": True, "vis_rgbd": True}})
        v = cfg.vis
        n_mesh = len(range(0, VIS_STEPS, v.save_mesh_freq))
        eng = engine_mod.Engine(cfg, device="cuda", quiet=True)
        recorder = ShapeRecorder(torch, kernels, prims)
        with recorder:
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.run(num_iter=VIS_STEPS)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
        counts = kernels.launch_counts()
        tm = eng.timer.timings
        log(f"[vis] {ACTIVE_CFG} seed {ACTIVE_SEED}, {VIS_STEPS} steps with "
            f"the saver: {run_s:.2f} s (phase 7's pace for {VIS_STEPS} "
            f"steps: {phase7['run_s'] * VIS_STEPS / phase7['steps']:.2f} s); "
            f"saver {sum(tm['Visualization']):.2f} s, simulation "
            f"{sum(tm['Simulation']):.2f} s over {len(tm['Simulation'])} "
            f"renders")
        poses = eng.mapper.poses[:VIS_STEPS].cpu()
        if not torch.equal(poses, phase7["poses"][:VIS_STEPS]):
            bad = [i for i in range(VIS_STEPS)
                   if not torch.equal(poses[i], phase7["poses"][i])]
            fail(f"the --enable_vis run's poses differ from phase 7's from "
                 f"step {bad[0]} ({len(bad)} of {VIS_STEPS})")
        log(f"[vis] the {VIS_STEPS} poses equal phase 7's bit for bit")
        ckpt = os.path.join(tmp, "ckpt_vis.pkl")
        eng.mapper.save_ckpt(ckpt)
        vis = eng.visualizer.root
        for sub in ("rgbd", "pose", "planning_path", "lookat_tgts", "state",
                    "color_mesh", "uncert_mesh"):
            n = len(os.listdir(os.path.join(vis, sub)))
            want = n_mesh if sub.endswith("_mesh") else VIS_STEPS
            if n != want:
                fail(f"visualization/{sub} holds {n} files, not {want}")
        panel_hw = (cfg.cam.H, 2 * cfg.cam.W, 3)
        for path in sorted(glob.glob(os.path.join(vis, "rgbd", "*.png"))):
            if read_png(path).shape != panel_hw:
                fail(f"{path} does not decode to {panel_hw}")
        on_lut = {tuple(c) for c in np.clip(
            raster.JET_LUT.astype(np.float32) * 255.0, 0, 255).astype(
            np.uint8)}
        for path in sorted(glob.glob(os.path.join(vis, "uncert_mesh",
                                                  "*.ply"))):
            cols = read_ply(path)[2]
            off = {tuple(c) for c in np.unique(cols, axis=0)} - on_lut
            if off:
                fail(f"{path}: {len(off)} colours off the jet table")
        log(f"[vis] {VIS_STEPS} files in each per-step directory, {n_mesh} "
            f"in each mesh directory; every rgbd panel decodes to "
            f"{panel_hw}; the uncertainty meshes' colours lie on the jet "
            f"table")
        out = os.path.join(tmp, "offline")
        walls = {}

        def tool(name, argv, shape, pattern=None, n=None, avi=None):
            t0 = time.perf_counter()
            offline.main(argv)
            walls[name] = time.perf_counter() - t0
            files = sorted(glob.glob(pattern)) if pattern else []
            if n is not None and len(files) != n:
                fail(f"offline {name} wrote {len(files)} images, not {n}")
            for f in files:
                if read_png(f).shape != shape:
                    fail(f"offline {name}: {f} does not decode to {shape}")
            if avi:
                frames = read_avi_frames(avi[0])
                if len(frames) != avi[1] or any(
                        fr.shape != avi[2] for fr in frames):
                    fail(f"offline {name}: {avi[0]} holds "
                         f"{len(frames)} frames of "
                         f"{frames[0].shape if frames else None}, not "
                         f"{avi[1]} of {avi[2]}")

        tool("traj", ["traj", "--run", vis, "--out", f"{out}_traj.png"],
             (600, 1200, 3), f"{out}_traj.png", 1)
        for kind in ("color_mesh", "uncert_mesh"):
            tool(f"mesh_evo {kind}", ["mesh_evo", "--run", vis, "--out",
                                      f"{out}_{kind}", "--kind", kind],
                 (480, 480, 3), f"{out}_{kind}/*.png", n_mesh)
        tool("video", ["video", "--run", vis, "--out", f"{out}_video.avi"],
             None, avi=(f"{out}_video.avi", VIS_STEPS, panel_hw))
        n_replay = len(range(0, VIS_STEPS, VIS_REPLAY_STRIDE))
        tool("replay", ["replay", "--run", vis, "--out", f"{out}_replay",
                        "--stride", str(VIS_REPLAY_STRIDE), "--video",
                        f"{out}_replay.avi"], (480, 640, 3),
             f"{out}_replay/*.png", n_replay,
             avi=(f"{out}_replay.avi", n_replay, (480, 640, 3)))
        t0 = time.perf_counter()
        export_pose.main(["--ckpt", ckpt, "--out", f"{out}_poses.npy"])
        walls["export_pose"] = time.perf_counter() - t0
        exported = np.load(f"{out}_poses.npy")
        if not np.array_equal(exported, eng.mapper.poses.cpu().numpy()):
            fail("export_pose's array differs from the run's poses")
        log("[vis] offline tools: " + ", ".join(
            f"{k} {s:.2f} s" for k, s in walls.items())
            + f"; every image and AVI frame decodes to its shape; "
            f"export_pose's {exported.shape} array equals the run's poses")
    log(f"[vis] {len(recorder.seen)} distinct (kernel, shape) in run(); "
        f"each against its plain version on the inputs of its first call:")
    return counts, recorder.replay("vis")

# -------------------------------------------------------------- phase 14
def sharded_state(mapper) -> dict:
    """What a BA iteration reads of a mapper, on the host: the field, the
    keyframes stored so far, the poses and the uncertainty volume."""
    from naruto_tpu_torch.parallel.dryrun import to_host

    n = mapper.kf.count
    rows = n * mapper.kf.rays_per_slot
    return to_host({"params": mapper.params,
                     "kf_rays": mapper.kf.rays[:rows],
                     "kf_frame_ids": mapper.kf.frame_ids[:n], "kf_count": n,
                     "poses": mapper.poses, "uncert_vol": mapper.uncert_vol})


def load_sharded_state(torch, mapper, st: dict) -> None:
    mapper.load_weights(st["params"])
    n = st["kf_count"]
    with torch.no_grad():
        mapper.kf.rays[:st["kf_rays"].shape[0]] = st["kf_rays"].to(
            mapper.device)
        mapper.kf.frame_ids[:n] = st["kf_frame_ids"].to(mapper.device)
        mapper.poses.copy_(st["poses"])
        mapper.uncert_vol.copy_(st["uncert_vol"])
    mapper.kf.count = n


def sharded_rank(mesh, payload) -> dict:
    """Phase 14 on one rank (spawned by naruto_tpu_torch/parallel/dryrun.py
    on every rank): the sharded volume query, one BA iteration from the
    payload's draws, SHARDED_STEPS BA steps from the rank's own draws (the
    same on every rank) with each iteration's launches and collectives,
    SHARDED_SITE_STEPS more with each collective timed alone, the field
    checked bit-identical across ranks, then the active run; rank
    0 replays its (kernel, shape) keys last, when the other ranks are
    done."""
    import torch

    from naruto_tpu_torch.config.schema import deep_update
    from naruto_tpu_torch.mapping.mapper import BADraws, Mapper
    from naruto_tpu_torch.ops import kernels, primitives
    from naruto_tpu_torch.parallel.dryrun import to_host
    from naruto_tpu_torch.parallel.mesh import (assert_replicated,
                                                collective_counts,
                                                reset_collective_counts,
                                                timed_collectives)
    from naruto_tpu_torch.system.engine import Engine

    dev = mesh.device
    mapper = Mapper(payload["cfg"], device=dev)
    if mapper._ba_mesh is None or mapper._sharded_vol is None:
        fail("phase 14: the mapper's sharded BA or volume query is off")
    load_sharded_state(torch, mapper, payload["state"])
    out = {"backend": mesh.backend, "device": str(dev)}
    recorder = ShapeRecorder(torch, kernels, primitives)
    kernels.reset_launch_counts()
    with recorder:
        reset_collective_counts()
        u, s = mapper.map_volumes()
        out["volume_collectives"] = collective_counts()
        out["volumes"] = (u.cpu(), s.cpu())
        # the BA reads the single-process volume, as the reference's
        # iteration does (the gathered one equals it within SHARDED_VOL_TOL)
        mapper.uncert_vol = payload["state"]["uncert_vol"].to(dev)
        frame_rays = mapper.frame_to_rays(*payload["frame"])
        c2w = torch.as_tensor(payload["c2w"], device=dev)
        setup = mapper._ba_setup(payload["bucket"], frame_rays, c2w,
                                 payload["fid"])
        reset_collective_counts()
        _, grads = mapper._ba_iteration(setup, BADraws(*[
            None if d is None else d.to(dev) for d in payload["draws"]]), 0)
        out["grads"] = to_host(grads)
        out["iter0_collectives"] = collective_counts()
        per_iter = []
        iteration = mapper._ba_iteration

        def counted(setup, draws, it):
            before = kernels.launch_counts()
            reset_collective_counts()
            res = iteration(setup, draws, it)
            after = kernels.launch_counts()
            per_iter.append(({k: after[k] - before[k]
                              for k in BA_LAUNCHES_PER_ITER},
                             collective_counts()))
            return res

        mapper._ba_iteration = counted
        # the padded-rank check runs beside this one: not in the window
        deadline = time.monotonic() + SHARDED_TIMEOUT_S
        while not os.path.exists(payload["quiet_card"]):
            if time.monotonic() > deadline:
                fail("phase 14: the padded-rank check never ended")
            time.sleep(0.05)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(SHARDED_STEPS):
            mapper._ba_impl(payload["bucket"], frame_rays, c2w,
                            payload["fid"])
        torch.cuda.synchronize(dev)
        out["ba_ms"] = 1e3 * (time.perf_counter() - t0) / len(per_iter)
        # then each collective alone: the work queued before it and its own
        # end awaited, its wall added to its site
        n0 = len(per_iter)
        with timed_collectives() as spent:
            t0 = time.perf_counter()
            for _ in range(SHARDED_SITE_STEPS):
                mapper._ba_impl(payload["bucket"], frame_rays, c2w,
                                payload["fid"])
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
        n = len(per_iter) - n0
        out["sites"] = {"iter_ms": 1e3 * wall / n, "bucket_mb": 4e-6 * sum(
            p.numel() for p in mapper._all_params()), **{
            f"{k}_ms": 1e3 * v / n for k, v in spent.items()}}
    out["per_iter"] = per_iter
    assert_replicated(mesh, mapper._all_params() + mapper.embed_opt.mu
                      + mapper.embed_opt.nu,
                      f"the field after "
                      f"{SHARDED_STEPS + SHARDED_SITE_STEPS} BA steps")
    out["ba_launches"] = kernels.launch_counts()
    del mapper, setup, frame_rays, grads, u, s
    torch.cuda.empty_cache()

    act = payload["active"]
    cfg = deep_update(act["cfg"], {"general": {
        "result_dir": act["result_dirs"][mesh.rank]}})
    eng = Engine(cfg, device=dev, quiet=True)
    if eng.mapper._ba_mesh is None:
        fail("phase 14: the active run's mapper is not sharded")
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize(dev)
    out["active"] = {"run_s": time.perf_counter() - t0,
                     "poses": eng.mapper.poses.cpu(),
                     "stats": eng.planner.stats_summary()}
    if eng.lead:
        eng.finalize()
        out["active"]["row"] = read_row(os.path.join(eng.run_dir,
                                                     "eval_result.txt"))
    out["launches"] = kernels.launch_counts()
    if mesh.rank == 0:
        log(f"[sharded] rank 0: {len(recorder.seen)} distinct (kernel, "
            f"shape) at the half-batch shapes; each against its plain "
            f"version on the inputs of its first call:")
        out["cases"] = recorder.replay("sharded")
    return out


def volumes_rank(mesh, payload) -> dict:
    """The sharded volume query on one rank of SHARDED_PAD_RANKS; then an
    NCCL group over the same ranks, which share the card: the premise of
    parallel/mesh.py's backend rule (the error, or None if it worked)."""
    import torch

    from naruto_tpu_torch.mapping.mapper import Mapper
    from naruto_tpu_torch.parallel.mesh import (collective_counts,
                                                reset_collective_counts)

    mapper = Mapper(payload["cfg"], device=mesh.device)
    mapper.load_weights(payload["params"])
    reset_collective_counts()
    u, s = mapper.map_volumes()
    out = {"volumes": (u.cpu(), s.cpu()),
           "collectives": collective_counts(), "nccl_error": None}
    try:
        group = torch.distributed.new_group(backend="nccl")
        torch.distributed.all_reduce(torch.ones(1, device=mesh.device),
                                     group=group)
        torch.cuda.synchronize(mesh.device)
    except torch.distributed.DistBackendError as e:
        out["nccl_error"] = str(e).strip().splitlines()[-1]
    return out


def check_sharded_volumes(torch, res: list, ref, what: str) -> None:
    rtol, atol = SHARDED_VOL_TOL
    for r, got in enumerate(res):
        for name, g, w in zip(("uncert", "sdf"), got, ref):
            if g.shape != w.shape or not torch.allclose(g, w, rtol=rtol,
                                                        atol=atol):
                fail(f"{what}: rank {r}'s {name} volume differs from the "
                     f"unsharded query by {float((g - w).abs().max()):.3e}")


def run_sharded(torch, kernels, prims, root: str) -> tuple:
    """Phase 14. Returns rank 0's launches and replayed cases."""
    import numpy as np

    from naruto_tpu_torch.config import load_config, make_config
    from naruto_tpu_torch.config.schema import deep_update
    from naruto_tpu_torch.mapping.mapper import Mapper
    from naruto_tpu_torch.parallel import mesh as pmesh
    from naruto_tpu_torch.parallel.dryrun import spawn, to_host
    from naruto_tpu_torch.sim.analytic import AnalyticSimulator

    t_phase = time.perf_counter()
    shard = {"parallel": {"shard_rays": True, "shard_volumes": True}}
    cfg = make_config("Replica", "office0", overrides=shard)
    sim = AnalyticSimulator(cfg, device="cuda")
    mapper = Mapper(cfg, device="cuda")        # no process group: one rank
    m = cfg.mapper
    for i in range(6):
        sim.update_step(i)
        mapper.update_step(i)
        color = depth = None
        if mapper.needs_frame(i):
            color, depth = sim.simulate(path_pose(i))
        mapper.online_recon_step(i, color, depth, path_pose(i))
    while mapper.kf.count < SHARDED_KEYFRAMES:
        fid = mapper.kf.count * m.keyframe_every
        sim.update_step(fid)
        color, depth = sim.simulate(path_pose(fid))
        mapper.poses[fid] = torch.as_tensor(path_pose(fid), device="cuda")
        mapper.add_keyframe(mapper.frame_to_rays(color, depth), fid)
    mapper.map_volumes()
    state = sharded_state(mapper)
    vols = [v.cpu() for v in mapper._volumes_impl()]
    bucket, fid = mapper._pick_bucket(mapper.kf.count), 110
    color, depth = sim.simulate(path_pose(fid))
    frame = (color.cpu(), depth.cpu())
    frame_rays = mapper.frame_to_rays(color, depth)
    c2w = torch.as_tensor(path_pose(fid), device="cuda")
    setup = mapper._ba_setup(bucket, frame_rays, c2w, fid)
    draws = mapper._draw_ba(setup)
    ref_grads = to_host(mapper._ba_iteration(setup, draws, 0)[1])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(SHARDED_STEPS):
        mapper._ba_impl(bucket, frame_rays, c2w, fid)
    torch.cuda.synchronize()
    one_ms = 1e3 * (time.perf_counter() - t0) / (SHARDED_STEPS * m.iters)
    rays = mapper._ba_n_rays(bucket)
    del mapper, setup, frame_rays, sim
    torch.cuda.empty_cache()

    prep_s = time.perf_counter() - t_phase
    active = deep_update(load_config(os.path.join(root, ACTIVE_CFG)), {
        **shard, "general": {"seed": ACTIVE_SEED,
                             "num_iter": SHARDED_ACTIVE_STEPS}})
    import threading

    with tempfile.TemporaryDirectory(prefix="sharded_") as tmp:
        # the padded-rank volume check in a thread beside the main ranks,
        # whose timed window waits for it to end (quiet_card)
        quiet = os.path.join(tmp, "quiet_card")
        padded = {}

        def padded_check():
            t0 = time.perf_counter()
            try:
                padded["res"] = spawn(
                    "chip_smoke:volumes_rank", SHARDED_PAD_RANKS,
                    {"cfg": cfg, "params": state["params"]}, device="cuda",
                    timeout=SHARDED_TIMEOUT_S)
            except BaseException as e:      # re-raised below
                padded["error"] = e
            padded["s"] = time.perf_counter() - t0
            open(quiet, "w").close()

        thread = threading.Thread(target=padded_check)
        t0 = time.perf_counter()
        thread.start()
        try:
            res = spawn("chip_smoke:sharded_rank", SHARDED_RANKS, {
                "cfg": cfg, "state": state, "frame": frame,
                "c2w": path_pose(fid), "fid": fid, "bucket": bucket,
                "draws": to_host(draws), "quiet_card": quiet,
                "active": {"cfg": active, "result_dirs": [
                    os.path.join(tmp, f"rank{r}")
                    for r in range(SHARDED_RANKS)]}},
                device="cuda", timeout=SHARDED_TIMEOUT_S)
        finally:
            thread.join()
        spawn_s = time.perf_counter() - t0
    if "error" in padded:
        raise padded["error"]
    r0 = res[0]
    log(f"[sharded] {SHARDED_RANKS} ranks on {r0['device']}, backend "
        f"{r0['backend']} (parallel/mesh.py's rule: the ranks share the "
        f"card); office0 at phase 4's width, {rays} rays a BA iteration "
        f"(bucket {bucket}), {rays // SHARDED_RANKS} a rank, "
        f"{SHARDED_KEYFRAMES} keyframes; the single-process setup and "
        f"reference {prep_s:.1f} s, the ranks {spawn_s:.1f} s (their "
        f"start, the checks, the active run)")
    for r, got in enumerate(res):
        for group, (rtol, atol) in SHARDED_GRAD_TOL.items():
            for i, (g, w) in enumerate(zip(got["grads"][group],
                                           ref_grads[group])):
                if not torch.allclose(g, w, rtol=rtol, atol=atol):
                    err = float((g - w).abs().max())
                    fail(f"rank {r}'s {group} gradient {i} differs from the "
                         f"single-process one by {err:.3e} (rtol {rtol}, "
                         f"atol {atol})")
        if got["iter0_collectives"] != SHARDED_COLLECTIVES_PER_ITER:
            fail(f"rank {r}'s first BA iteration made "
                 f"{got['iter0_collectives']}")
        launches = [n for n, _ in got["per_iter"]]
        colls = [c for _, c in got["per_iter"]]
        check_ba_launches(launches, what=f"rank {r}'s sharded BA")
        wrong = [c for c in colls if c != SHARDED_COLLECTIVES_PER_ITER]
        if wrong:
            fail(f"{len(wrong)} of rank {r}'s {len(colls)} BA iterations "
                 f"made other collectives than "
                 f"{SHARDED_COLLECTIVES_PER_ITER}: {wrong[0]}")
        if got["volume_collectives"] != {**{k: 0 for k in
                                             SHARDED_COLLECTIVES_PER_ITER},
                                          "volumes": 1}:
            fail(f"rank {r}'s volume query made "
                 f"{got['volume_collectives']}")
    worst = {group: max(float((g - w).abs().max()) for g, w in
                        zip(r0["grads"][group], ref_grads[group]))
             for group in SHARDED_GRAD_TOL}
    log(f"[sharded] one BA iteration's gradients from the same state and "
        f"draws on every rank against the single-process gradient: max "
        f"|diff| {', '.join(f'{k} {v:.3e}' for k, v in worst.items())} "
        f"(tolerances {SHARDED_GRAD_TOL})")
    check_sharded_volumes(torch, [g["volumes"] for g in res], vols,
                          f"{SHARDED_RANKS} ranks")
    n = vols[0].numel()
    log(f"[sharded] the (49, 56, 35) volume query ({n} voxels) on "
        f"{SHARDED_RANKS} ranks equals the unsharded one (rtol, atol "
        f"{SHARDED_VOL_TOL}); one collective a query")
    log(f"[sharded] {len(r0['per_iter'])} BA iterations a rank "
        f"({SHARDED_STEPS + SHARDED_SITE_STEPS} steps): each launched "
        f"{BA_LAUNCHES_PER_ITER} "
        f"and made {SHARDED_COLLECTIVES_PER_ITER}; field and table Adam "
        f"moments bit-identical across ranks after them")
    log(f"[sharded] BA iteration wall: 1 rank {one_ms:.2f} ms, "
        f"{SHARDED_RANKS} ranks {r0['ba_ms']:.2f} ms (rank 0; "
        f"{SHARDED_RANKS} ranks sharing one H100; not a scaling figure)")
    for r, got in enumerate(res):
        st = got["sites"]
        log(f"[sharded] rank {r}, {SHARDED_SITE_STEPS} BA steps with each "
            f"collective timed alone (the queued work and its own end "
            f"awaited): an iteration {st['iter_ms']:.2f} ms, of it the "
            f"gradient bucket ({st['bucket_mb']:.2f} MB of f32) "
            f"{st['gradients_ms']:.2f} ms and the denominators "
            f"{st['denominators_ms']:.3f} ms ({SHARDED_RANKS} ranks sharing "
            f"one H100 over {r0['backend']})")
    pad = padded["res"]
    check_sharded_volumes(torch, [g["volumes"] for g in pad], vols,
                          f"{SHARDED_PAD_RANKS} ranks")
    if any(g["collectives"]["volumes"] != 1 for g in pad):
        fail(f"a volume query on {SHARDED_PAD_RANKS} ranks made "
             f"{[g['collectives'] for g in pad]}")
    log(f"[sharded] on {SHARDED_PAD_RANKS} ranks ({pmesh.pad_to(n, 3) - n} "
        f"padded voxels): the unsharded volumes, one collective a query "
        f"({padded['s']:.1f} s with the ranks' start, beside the "
        f"{SHARDED_RANKS} ranks' start)")
    nccl = pad[0]["nccl_error"]
    log(f"[sharded] NCCL over the {SHARDED_PAD_RANKS} ranks sharing the "
        f"card: " + (f"refused ({nccl}); hence Gloo" if nccl else
                     "accepted (parallel/mesh.py's rule still picks Gloo)"))
    a0 = r0["active"]
    for r, got in enumerate(res[1:], 1):
        if not torch.equal(got["active"]["poses"], a0["poses"]):
            fail(f"the active run's poses on rank {r} differ from rank 0's")
    row = a0["row"]
    log(f"[sharded] {ACTIVE_CFG} seed {ACTIVE_SEED}, "
        f"{SHARDED_ACTIVE_STEPS} steps on {SHARDED_RANKS} ranks: "
        f"{a0['run_s']:.2f} s (rank 0; ranks sharing one card), equal "
        f"poses on every rank, {a0['stats']['n_plans']} plans; rank 0's "
        f"row: " + ", ".join(f"{k} {v:.4f}" for k, v in row.items()))
    if not all(math.isfinite(v) for v in row.values()):
        fail(f"the sharded active run's row is not finite: {row}")
    idle = [k for k in BA_LAUNCHES_PER_ITER
            if BA_LAUNCHES_PER_ITER[k] and not r0["launches"][k]]
    if idle:
        fail(f"the sharded path never launched {idle}")
    log(f"[sharded] phase 14 in {time.perf_counter() - t_phase:.1f} s; "
        f"rank 0's launches {r0['launches']}")
    return r0["launches"], r0["cases"]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="also profile one BA step; trace and table to DIR")
    args = ap.parse_args()
    t_start = time.perf_counter()
    # the port never needs jax, nor the JAX package: importing either
    # raises (a finder, not a None in sys.modules, which scipy's array-API
    # checks would take for a module)
    sys.meta_path.insert(0, BlockImports(("jax", "naruto_tpu")))

    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: the port runs on the card only")
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from naruto_tpu_torch.ops import kernels, primitives, segment

    dev = torch.device("cuda")
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}")
    card = card_line()
    log(f"[device] {card}")
    t0 = time.perf_counter()
    build = kernels.build()
    log(f"[build] {len(build)} sources built in parallel and loaded in "
        f"{time.perf_counter() - t0:.2f} s")
    for src, rec in build.items():
        took = "already built" if rec["seconds"] is None else \
            f"nvcc {rec['seconds']:.2f} s"
        log(f"[build] csrc/{src}.cu: {took}")
        for line in rec["ptxas"].splitlines():
            if "ptxas info" in line:
                log(f"[build] {line.strip()}")

    kres = check_kernels(torch, kernels, dev)
    from naruto_tpu_torch.config import make_config
    from naruto_tpu_torch.mapping.mapper import field_spec_from_config

    spec = field_spec_from_config(make_config("Replica", "office0")).hash_spec
    check_segment_sum(torch, segment, spec, dev)
    check_trilinear_vjp(torch, dev)
    sres = run_slice(torch, kernels, args.profile)
    pres = check_primitives(torch, primitives, dev)
    hres = check_host_costs(torch, kernels, primitives, dev)
    bench_launches = run_microbenchmarks(torch, kernels)
    # the snapshots phases 6 and 10 write, for phase 11 (hundreds of MB:
    # in a temporary directory outside the checkout)
    keep = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    passive_keep = {}

    def keep_passive(eng, row):
        moved = {k: (row[k], v) for k, v in PORT_PASSIVE_ROW.items()
                 if row[k] != v}
        if moved:
            fail(f"phase 6's row with snapshots differs from its row "
                 f"without them (PORT_PASSIVE_ROW): {moved}")
        snap = os.path.join(keep.name, "passive_full_state.pkl")
        shutil.copyfile(eng.snapshot_path(), snap)
        passive_keep.update(snapshot=snap, row=row,
                            poses=eng.mapper.poses.cpu().clone())
        log(f"[passive] the snapshot of step {PASSIVE_SNAPSHOT_STEP} "
            f"(general.ckpt_freq {PASSIVE_SNAPSHOT_STEP}): "
            f"{os.path.getsize(snap) / 2 ** 20:.1f} MiB written in "
            f"{eng.timer.timings['full_state_save'][0]:.3f} s; the row is "
            f"the row without snapshots, digit for digit")

    passive, passive_cases = run_passive(
        torch, kernels, primitives, root,
        over={"general": {"ckpt_freq": PASSIVE_SNAPSHOT_STEP}},
        check=keep_passive)
    phase7 = {}

    def keep_active(eng, row, summary):
        phase7.update(poses=eng.mapper.poses.cpu().clone(),
                      run_s=eng.run_seconds, steps=eng.cfg.general.num_iter)

    active, active_cases = run_active(torch, kernels, primitives, root,
                                      check=keep_active)
    import yaml

    with open(os.path.join(root, PARITY_CFG)) as f:
        parity_grid = yaml.safe_load(f)["grid"]
    parity, parity_cases = run_passive(
        torch, kernels, primitives, root, "parity",
        over={"grid": parity_grid}, reference=PARITY_ROW,
        want=PARITY_LAUNCHES_PER_ITER)
    settings, settings_cases = run_passive(
        torch, kernels, primitives, root, "settings", over=SETTINGS_OVER,
        num_iter=SETTINGS_STEPS, reference=None,
        want=SETTINGS_LAUNCHES_PER_ITER, check=check_tracking())
    track_path(torch, kernels)
    raycast, raycast_cases, raycast_info = run_raycast(
        torch, kernels, primitives, root, keep.name)

    def same_as_phase6(eng, row):
        if not torch.equal(eng.mapper.poses.cpu(), passive_keep["poses"]):
            fail("the resumed passive run's poses differ from phase 6's")
        if row != passive_keep["row"]:
            fail(f"the resumed passive run's row {row} differs from phase "
                 f"6's {passive_keep['row']}")
        log("[resumed] passive: every pose bit for bit phase 6's, the row "
            "phase 6's digit for digit")

    resumed_p, resumed_p_cases = run_passive(
        torch, kernels, primitives, root, "resumed",
        over={"general": {"ckpt_freq": PASSIVE_SNAPSHOT_STEP}},
        check=same_as_phase6, resume_from=passive_keep["snapshot"])
    resumed_a, resumed_a_cases = run_resumed_active(torch, kernels,
                                                    primitives, raycast_info)
    keep.cleanup()
    resumed = {k: resumed_p[k] + resumed_a[k] for k in resumed_p}
    resumed_cases = {k: resumed_p_cases[k] + resumed_a_cases[k]
                     for k in resumed_p_cases}
    replay, replay_cases, _ = run_replay(torch, kernels, primitives, root)
    vis, vis_cases = run_vis(torch, kernels, primitives, root, phase7)
    sharded, sharded_cases = run_sharded(torch, kernels, primitives, root)
    for path, counts in (("raycast", raycast), ("resumed", resumed),
                         ("replay", replay), ("vis", vis),
                         ("sharded", sharded)):
        idle = [k for k in BA_LAUNCHES_PER_ITER
                if BA_LAUNCHES_PER_ITER[k] and not counts[k]]
        if idle:
            fail(f"the {path} path never launched {idle}")
    runs = (("passive", passive, passive_cases),
            ("active", active, active_cases),
            ("parity", parity, parity_cases),
            ("settings", settings, settings_cases),
            ("raycast", raycast, raycast_cases),
            ("resumed", resumed, resumed_cases),
            ("replay", replay, replay_cases),
            ("vis", vis, vis_cases),
            ("sharded", sharded, sharded_cases))

    def summary(case: dict) -> dict:
        return {**{k: case[k] for k in ("shape", "max_abs_err", "ms",
                                        "plain_ms", "bound_ms", "bound_by",
                                        "library_ms")},
                "device_ms": case.get("device_ms"),
                "library_device_ms": case.get("library_device_ms")}

    def in_brief(cases: list):
        """A kernel's shapes on a run, in brief for the JSON line (each has
        its own [kernels] line above)."""
        if not cases:
            return None
        worst = max(cases, key=lambda c: c["rel_err"])
        return {"shapes": len(cases), "calls": sum(c["calls"] for c in cases),
                "worst_shape": worst["shape"],
                "worst_rel_err": worst["rel_err"], "err_of": worst["err_of"]}

    on_slice = sres["launches"]
    # the fused scan: the BA runs its slot rows, and its full rows nowhere
    entries = [{
        "name": "outer_scan", "route": "cuda", "source": SOURCE["outer_scan"],
        "replaces": REPLACES["outer_scan"],
        "launches": on_slice["outer_scan_slots"] + on_slice["outer_scan_rows"],
        "launches_by_epilogue": {"slots": on_slice["outer_scan_slots"],
                                 "rows": on_slice["outer_scan_rows"]},
        "launches_by_path": {
            path: counts["outer_scan_slots"] + counts["outer_scan_rows"]
            for path, counts, _ in (("slice", on_slice, None), *runs)},
        **summary(kres["slots"][0]), **hres["outer_scan_slots"],
        "epilogues": kres,
        **{f"{path}_shapes": {
            "slots": in_brief(cases["outer_scan_slots"]),
            "rows": in_brief(cases["outer_scan_rows"])}
           for path, _, cases in runs},
        "host_by_epilogue": {"slots": hres["outer_scan_slots"],
                             "rows": hres["outer_scan_rows"]}}]
    for name in PRIM_KERNELS:
        # the main path a kernel is on: the BA slice, else the
        # microbenchmarks; its numbers are those of that path's first shape
        path = "slice" if BA_LAUNCHES_PER_ITER[name] else "microbenchmarks"
        main_case = next(c for c in pres[name] if c["path"] == path)
        entries.append({
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name],
            "launches": (on_slice if path == "slice"
                         else bench_launches)[name],
            "launches_by_path": {"slice": on_slice[name],
                                 "microbenchmarks": bench_launches[name],
                                 **{path: counts[name]
                                    for path, counts, _ in runs}},
            **summary(main_case), **hres[name], "cases": pres[name],
            **{f"{path}_shapes": in_brief(cases[name])
               for path, _, cases in runs}})
    log(f"[smoke] all phases in {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": entries}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
