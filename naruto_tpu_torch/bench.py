"""Benchmark of the port: steady-state mapping-iteration throughput on one
NVIDIA card (counterpart of the repository's bench.py, which times the JAX
package).

    python -m naruto_tpu_torch.bench [--steps 30] [--windows 5] [--settle 10]

It times the workload of bench.py's `_measure`: `make_config("Replica",
"office0")`, a synthetic wall frame at full sensor resolution (depth 1.5, a
colour ramp), 22 keyframes added from it (the smallest current-ray bucket,
512), a warm-up BA step (the first one builds and loads the CUDA kernels),
`--settle` untimed steps, then chained BA steps between two
`torch.cuda.synchronize()`. One BA step is `mapper.iters` (10) iterations,
one captured CUDA graph a step on the card (mapping/ba_graph.py; the first
step of the bucket warms up and captures it).

Two rows share the process: parity (the defaults) and turbo
(configs/turbo.yaml: `smooth_every: 5`, `n_samples_d: 12`), reported
beside it, never as it. `measure(..., eager=True)` adds a row that times
the parity configuration's eager BA call (`Mapper._ba_impl_eager`, one
Python iteration after another), the form the graph replaced
(`chip_smoke.py` phase 15). iters/s of two
processes on one card differ by more than most changes move it, so the
rows are timed in turns inside one process, `--windows` windows of
`--steps` steps each, the order of the rows alternating from window to
window; each row reports its median and range.

As in bench.py, the environment variable NARUTO_BENCH_CFG (a JSON dict of
config overrides, e.g. '{"grid": {"layout": "vertex", ...}}' for the grid
of configs/parity.yaml) times that configuration instead of the defaults,
alone: the turbo row is not timed then.

Prints one JSON line with bench.py's keys (`metric`, `value`, `unit`,
`vs_baseline`, `extra`). `vs_baseline` is over the same estimate bench.py
divides by: ~100 mapping iters/s for the reference on an RTX 3090 (see
bench.py's docstring). It needs a card: without one it exits non-zero and
times nothing.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from typing import Dict

import numpy as np
import torch

BASELINE_ITERS_PER_SEC = 100.0  # RTX 3090 estimate (bench.py's docstring)
TURBO = {"training": {"smooth_every": 5, "n_samples_d": 12}}
N_KEYFRAMES = 22


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def wall_frame(H: int, W: int):
    """bench.py's synthetic wall frame: depth 1.5 everywhere, colour a
    horizontal ramp in red over constant green and blue."""
    depth = np.full((H, W), 1.5, dtype=np.float32)
    u = np.linspace(0, 1, W, dtype=np.float32)
    color = np.stack([np.tile(u, (H, 1)),
                      np.full((H, W), 0.3, np.float32),
                      np.full((H, W), 0.6, np.float32)], axis=-1)
    return color, depth


class _Row:
    """One configuration's mapper, driven to steady state and warmed up."""

    def __init__(self, cfg, device: torch.device, settle: int,
                 eager: bool = False):
        from naruto_tpu_torch.mapping.mapper import Mapper

        self.cfg = cfg
        self.device = device
        self.mapper = m = Mapper(cfg, device=device)
        self._ba = m._ba_impl_eager if eager else m._ba_impl
        color, depth = wall_frame(m.H, m.W)
        self.frame_rays = m.frame_to_rays(color, depth)
        self.c2w = torch.eye(4, device=device)
        for s in range(N_KEYFRAMES):
            m.add_keyframe(self.frame_rays, s * cfg.mapper.keyframe_every)
        self.bucket = m._pick_bucket(m.kf.count)
        _sync(device)
        t0 = time.perf_counter()
        self._steps(1, 110)
        _sync(device)
        self.compile_s = time.perf_counter() - t0
        self._steps(settle, 100)
        _sync(device)
        self.windows = []

    def _steps(self, n: int, fid0: int) -> None:
        for i in range(n):
            self._ba(self.bucket, self.frame_rays, self.c2w, fid0 + i)

    def window(self, n_steps: int) -> None:
        """Time n_steps chained BA steps; records iters/s."""
        _sync(self.device)
        t0 = time.perf_counter()
        self._steps(n_steps, 110)
        _sync(self.device)
        elapsed = time.perf_counter() - t0
        self.windows.append(n_steps * self.cfg.mapper.iters / elapsed)

    def summary(self) -> Dict:
        """bench.py `_measure`'s keys, iters_per_sec the windows' median,
        plus the range and every window."""
        its = statistics.median(self.windows)
        rays_per_iter = self.cfg.mapper.sample + self.bucket // 4
        return {
            "iters_per_sec": its,
            "rays_per_sec": round(its * rays_per_iter, 1),
            "rays_per_iter": rays_per_iter,
            "samples_per_ray": self.mapper.rc.n_samples,
            "bucket": self.bucket,
            "compile_s": round(self.compile_s, 2),
            "iters_per_sec_range": [round(min(self.windows), 2),
                                    round(max(self.windows), 2)],
            "iters_per_sec_windows": [round(w, 2) for w in self.windows],
        }


def measure(cfg, n_steps: int, windows: int, settle: int = 10,
            device="cuda", turbo: bool = True,
            eager: bool = False) -> Dict[str, Dict]:
    """The parity row (`cfg`), with `turbo` the turbo row and with `eager`
    the parity configuration's eager call, timed in turns: `windows`
    windows of `n_steps` BA steps each. Returns {"parity": ..., "turbo":
    ..., "eager": ...} of `_Row.summary()` dicts, plus the process's peak
    device memory (GiB, every row's mapper resident) under
    "peak_memory_gib" on a card."""
    from naruto_tpu_torch.config.schema import deep_update

    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    rows = {"parity": _Row(cfg, device, settle)}
    if turbo:
        rows["turbo"] = _Row(deep_update(cfg, TURBO), device, settle)
    if eager:
        rows["eager"] = _Row(cfg, device, settle, eager=True)
    order = list(rows)
    for w in range(windows):
        for name in (order if w % 2 == 0 else order[::-1]):
            rows[name].window(n_steps)
    out = {name: row.summary() for name, row in rows.items()}
    out["peak_memory_gib"] = (
        round(torch.cuda.max_memory_allocated(device) / 2 ** 30, 3)
        if device.type == "cuda" else None)
    return out


def bench_result(res: Dict, device_name: str, card: str) -> Dict:
    """bench.py's JSON line from `measure`'s result."""
    parity, turbo = dict(res["parity"]), res.get("turbo")
    its = parity.pop("iters_per_sec")
    out = {
        "metric": "mapping_iters_per_sec",
        "value": round(its, 2),
        "unit": "iters/s",
        "vs_baseline": round(its / BASELINE_ITERS_PER_SEC, 3),
        "extra": {
            **parity, "device": device_name,
            "card": card,
            "peak_memory_gib": res["peak_memory_gib"],
        },
    }
    if turbo is not None:
        out["extra"]["turbo"] = {
            "iters_per_sec": round(turbo["iters_per_sec"], 2),
            "vs_baseline": round(
                turbo["iters_per_sec"] / BASELINE_ITERS_PER_SEC, 3),
            "compile_s": turbo["compile_s"],
            "iters_per_sec_range": turbo["iters_per_sec_range"],
            "iters_per_sec_windows": turbo["iters_per_sec_windows"],
        }
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=30,
                    help="BA steps in each timed window")
    ap.add_argument("--windows", type=int, default=5,
                    help="timed windows of each row, in turns")
    ap.add_argument("--settle", type=int, default=10,
                    help="untimed BA steps after the warm-up step")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("naruto_tpu_torch.bench: no CUDA device; the benchmark times "
              "the card only", file=sys.stderr)
        raise SystemExit(1)

    from naruto_tpu_torch.config import make_config
    from naruto_tpu_torch.config.schema import deep_update

    cfg = make_config("Replica", "office0")
    env_over = os.environ.get("NARUTO_BENCH_CFG")
    if env_over:
        cfg = deep_update(cfg, json.loads(env_over))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    res = measure(cfg, args.steps, args.windows, args.settle, "cuda",
                  turbo=not env_over)
    print(json.dumps(bench_result(res, torch.cuda.get_device_name(0), card)))


if __name__ == "__main__":
    main()
