"""Probe the passive run's final extraction (configs/ab/passive_traj_ab.yaml)
on one NVIDIA card: one chunk of the mesh extraction's dense query, the
first 2^20 points of the grid at mesh.voxel_final through the field (random
weights from the seed), timed by CUDA events and by the profiler's device
time (trace_summary.device_ms), then its kernels by launching operator
(trace_summary's table). Run it in a fresh process: in one that has run the
mapper the profiler loses records.

Run:  python -m naruto_tpu_torch.scripts.probe_passive [--out DIR]

The chunk's chrome trace goes to DIR (a temporary directory by default).
"""
from __future__ import annotations

import argparse
import os
import statistics
import tempfile
from pathlib import Path

import numpy as np
import torch

from naruto_tpu_torch.config import load_config
from naruto_tpu_torch.config.schema import deep_update
from naruto_tpu_torch.geometry.voxel import voxel_axes
from naruto_tpu_torch.mapping.field import query_sdf
from naruto_tpu_torch.mapping.mapper import Mapper
from naruto_tpu_torch.mesh.extract import EXTRACT_CHUNK
from naruto_tpu_torch.scripts import trace_summary

ROOT = Path(__file__).resolve().parents[2]
PASSIVE_CFG = ROOT / "configs" / "ab" / "passive_traj_ab.yaml"
CHUNK_REPS = 5


def extraction_chunk(cfg, out_dir: str) -> None:
    mapper = Mapper(cfg, device="cuda")
    bound = np.asarray(cfg.mapper.marching_cubes_bound, np.float32)
    axes = voxel_axes(bound, cfg.mesh.voxel_final)
    n_grid = int(np.prod([len(a) for a in axes]))
    pts = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    pts = pts[:EXTRACT_CHUNK].astype(np.float32)
    fb = mapper.spec.bound_np
    x01 = torch.from_numpy((pts - fb[:, 0]) / (fb[:, 1] - fb[:, 0])).cuda()

    def chunk():
        with torch.no_grad():
            return query_sdf(mapper.params, x01, mapper.spec,
                             with_uncert=True)

    chunk()
    times = []
    for _ in range(10):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        chunk()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    dev = trace_summary.device_ms(chunk, reps=CHUNK_REPS)
    print(f"[chunk] {x01.shape[0]} of the {n_grid} grid points at "
          f"{cfg.mesh.voxel_final} m: {statistics.median(times):.3f} ms "
          f"(CUDA events, median of 10), device "
          + ("not measured" if np.isnan(dev) else f"{dev:.3f} ms"),
          flush=True)

    from torch.profiler import ProfilerActivity, profile

    lead = torch.empty(1, dtype=torch.int8, device="cuda")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trace_summary.lead_launch(lead)
        for _ in range(CHUNK_REPS):
            chunk()
        torch.cuda.synchronize()
    path = os.path.join(out_dir, "extract_chunk_trace.json")
    prof.export_chrome_trace(path)
    print(f"[chunk] kernels by launching operator, per chunk "
          f"({CHUNK_REPS} chunks traced; the int8 fill is the lead launch):",
          flush=True)
    trace_summary.main([path, "--iters", str(CHUNK_REPS), "--top", "30"])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="directory for the chunk's trace")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_passive: needs a CUDA card")
    with tempfile.TemporaryDirectory() as tmp:
        out = args.out or tmp
        os.makedirs(out, exist_ok=True)
        cfg = load_config(str(PASSIVE_CFG))
        cfg = deep_update(cfg, {"general": {"result_dir": tmp}})
        extraction_chunk(cfg, out)


if __name__ == "__main__":
    main()
