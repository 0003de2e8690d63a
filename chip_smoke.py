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
     kernel ran.

Every timed case also states its bound (the larger of the bytes it must
move over the card's memory rate and its operations over the card's f32
rate, from the published H100 SXM peaks) and, where one PyTorch call
computes the same function, that call's time.

The last line is {"ok": true, "device": {...}}; the line before it is the
card's name and power limit, and the line before that the kernels' JSON.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
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


def check_ba_launches(per_iter: list) -> None:
    wrong = [(i, n) for i, n in enumerate(per_iter)
             if n != BA_LAUNCHES_PER_ITER]
    if wrong:
        fail(f"{len(wrong)} of {len(per_iter)} BA iterations launched other "
             f"than {BA_LAUNCHES_PER_ITER}; first: iteration {wrong[0][0]}: "
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


def kernel_case(torch, name: str, shape: str, kernel, plain, tol: float,
                nbytes: float, flops: float = 0.0, library=None,
                profiled: bool = False, deterministic: bool = False) -> dict:
    """One kernel against its plain version on the same card tensors, then
    both timed: the median of PRIM_REPS CUDA-event launches, and where
    `profiled`, the device time from the profiler. `deterministic`: a
    second kernel call must give the same bits. nbytes / flops: what the
    function must move and compute, for its bound; `library`: one PyTorch
    call that computes the same function, timed beside it."""
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
    scale = float(ref.float().abs().max()) if ref.numel() else 0.0
    rel = abs_err / scale if scale else abs_err
    if not math.isfinite(rel) or rel > tol:
        fail(f"{name} {shape}: error {rel:.3e} of max|plain| > {tol}")
    bound_ms, bound_by = bound(nbytes, flops)
    res = {"shape": shape, "max_abs_err": abs_err, "rel_err": rel,
           "ms": cuda_ms(kernel, PRIM_REPS),
           "plain_ms": cuda_ms(plain, PRIM_REPS),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": cuda_ms(library, LIBRARY_REPS) if library else None}
    line = (f"[kernels] {name} {shape}: max|kernel-plain| {abs_err:.3e} = "
            f"{rel:.3e} of max|plain| (tol {tol}); kernel {res['ms']:.4f} "
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="also profile one BA step; trace and table to DIR")
    args = ap.parse_args()
    t_start = time.perf_counter()
    sys.modules["jax"] = None             # the port never needs jax,
    sys.modules["naruto_tpu"] = None      # nor the JAX package

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

    def summary(case: dict) -> dict:
        return {**{k: case[k] for k in ("shape", "max_abs_err", "ms",
                                        "plain_ms", "bound_ms", "bound_by",
                                        "library_ms")},
                "device_ms": case.get("device_ms"),
                "library_device_ms": case.get("library_device_ms")}

    on_slice = sres["launches"]
    # the fused scan: the BA runs its slot rows, and its full rows nowhere
    entries = [{
        "name": "outer_scan", "route": "cuda", "source": SOURCE["outer_scan"],
        "replaces": REPLACES["outer_scan"],
        "launches": on_slice["outer_scan_slots"] + on_slice["outer_scan_rows"],
        "launches_by_epilogue": {"slots": on_slice["outer_scan_slots"],
                                 "rows": on_slice["outer_scan_rows"]},
        **summary(kres["slots"][0]), **hres["outer_scan_slots"],
        "epilogues": kres,
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
                                 "microbenchmarks": bench_launches[name]},
            **summary(main_case), **hres[name], "cases": pres[name]})
    log(f"[smoke] all phases in {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": entries}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
