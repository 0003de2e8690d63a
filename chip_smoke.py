#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (naruto_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--profile DIR]

Phases (any failure exits non-zero, and nothing is printed as a result):
  1. device and build: torch/CUDA versions, the card's name and power
     limit, the hash-grid backward kernels compiled from csrc/ with nvcc;
  2. kernels: K2 chunk_totals and K1 outer_cumsum against their plain
     PyTorch versions on the same card tensors, at the mapping step's shape
     (M = 493,568 rows, 8 x 8) and at small shapes, with both timed;
  3. segment sum: the hash-grid backward's segment sum through the kernels
     on the card against the same function through the plain versions on
     the host, at the mapping step's point count and table size;
  4. the slice: the mapper's online entry point at the full Replica/office0
     defaults (680x1200 frames rendered by the analytic simulator, L4F8
     hybrid hash grid, active-ray BA with 43 samples per ray), steps 0..10;
     the keyframe store filled to 22 keyframes; a warm window of BA steps
     timed as bench.py times the JAX package (mapping iterations / s).

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
SLICE_M, SLICE_K = 493_568, 8
SMALL_SHAPES = ((512, 8, 4), (4608, 8, 4), (512, 2, 2), (4608, 2, 2))
WINDOW_STEPS = 20          # timed BA steps in the warm window
KERNEL_SOURCE = "naruto_tpu_torch/csrc/outer_cumsum.cu"
REPLACES = {
    "chunk_totals": "naruto_tpu/ops/pallas_kernels.py:78",
    "outer_cumsum": "naruto_tpu/ops/pallas_kernels.py:57",
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


# ------------------------------------------------------------------ phase 2
def check_kernels(torch, kernels, dev) -> dict:
    """K2 and K1 against their plain versions; returns the slice-shape
    errors and median times."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    result = {}
    for m, ka, kb in ((SLICE_M, SLICE_K, SLICE_K),) + SMALL_SHAPES:
        sa = torch.randn((m, ka), generator=gen, device=dev).bfloat16()
        sb = torch.randn((m, kb), generator=gen, device=dev).bfloat16()
        tot = kernels.chunk_totals(sa, sb)
        tot_ref = kernels.chunk_totals_plain(sa, sb)
        offs = torch.cumsum(tot_ref, 0) - tot_ref
        out = kernels.outer_cumsum(sa, sb, offs)
        out_ref = kernels.outer_cumsum_plain(sa, sb, offs)
        torch.cuda.synchronize()
        errs = {}
        for name, got, ref in (("chunk_totals", tot, tot_ref),
                               ("outer_cumsum", out, out_ref)):
            abs_err = float((got - ref).abs().max())
            rel = abs_err / float(ref.abs().max())
            errs[name] = (abs_err, rel)
            if not math.isfinite(rel) or rel > KERNEL_TOL:
                fail(f"{name} M={m} {ka}x{kb}: error {rel:.3e} of max|ref| "
                     f"> {KERNEL_TOL}")
        log(f"[kernels] M={m} {ka}x{kb}: chunk_totals err "
            f"{errs['chunk_totals'][1]:.3e}, outer_cumsum err "
            f"{errs['outer_cumsum'][1]:.3e} (of max|plain|, tol "
            f"{KERNEL_TOL})")
        if m == SLICE_M:
            reps = 50
            ms = {
                "chunk_totals": (
                    cuda_ms(lambda: kernels.chunk_totals(sa, sb), reps),
                    cuda_ms(lambda: kernels.chunk_totals_plain(sa, sb), reps)),
                "outer_cumsum": (
                    cuda_ms(lambda: kernels.outer_cumsum(sa, sb, offs), reps),
                    cuda_ms(lambda: kernels.outer_cumsum_plain(sa, sb, offs),
                            reps)),
            }
            for name, (k_ms, p_ms) in ms.items():
                result[name] = {"max_abs_err": errs[name][0],
                                "rel_err": errs[name][1],
                                "ms": k_ms, "plain_ms": p_ms}
                log(f"[kernels] {name} at M={m}: kernel {k_ms:.4f} ms, "
                    f"plain {p_ms:.4f} ms (median of {reps})")
    return result


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


def run_slice(torch, kernels, profile_dir) -> dict:
    import numpy as np

    from naruto_tpu_torch.config import make_config
    from naruto_tpu_torch.mapping.mapper import Mapper
    from naruto_tpu_torch.sim.analytic import AnalyticSimulator

    cfg = make_config("Replica", "office0")
    m = cfg.mapper
    sim = AnalyticSimulator(cfg, device="cuda")
    mapper = Mapper(cfg, device="cuda")
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
                f"launches so far {counts}, last loss "
                f"{float(mapper.last_aux[-1]['total']):.5f}")
            if any(v != iters_run for v in counts.values()):
                fail(f"kernel launches {counts} != iterations {iters_run}: "
                     f"a mapping iteration did not run both kernels once")
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
    if any(v != iters_run for v in counts.values()):
        fail(f"kernel launches {counts} != iterations {iters_run}")
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
    """One BA step under torch.profiler: kernel time by name and the
    device's busy share; the trace and the table go to out_dir."""
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="also profile one BA step; trace and table to DIR")
    args = ap.parse_args()
    sys.modules["jax"] = None             # the port never needs jax

    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: the port runs on the card only")
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from naruto_tpu_torch.ops import kernels, segment

    dev = torch.device("cuda")
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}")
    card = card_line()
    log(f"[device] {card}")
    build = kernels.build()
    log(f"[build] {KERNEL_SOURCE} built and loaded in {build['seconds']:.2f} "
        f"s")
    for line in build["ptxas"].splitlines():
        if "ptxas info" in line:
            log(f"[build] {line.strip()}")

    kres = check_kernels(torch, kernels, dev)
    from naruto_tpu_torch.config import make_config
    from naruto_tpu_torch.mapping.mapper import field_spec_from_config

    spec = field_spec_from_config(make_config("Replica", "office0")).hash_spec
    check_segment_sum(torch, segment, spec, dev)
    sres = run_slice(torch, kernels, args.profile)

    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": REPLACES[name], "launches": sres["launches"][name],
         "max_abs_err": kres[name]["max_abs_err"], "ms": kres[name]["ms"],
         "plain_ms": kres[name]["plain_ms"]}
        for name in ("chunk_totals", "outer_cumsum")]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
