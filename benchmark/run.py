"""The benchmark of naruto_tpu_torch on NVIDIA cards: one cell a run.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

A cell of BENCHMARK.json names a configuration (its file, under
benchmark/configs/), a traffic mix (benchmark/traffic/<name>.json, whose
"kind" names the cell class of benchmark/kinds/<kind>.py) and the chips it
needs. A run:

1. refuses to run, and prints no result, without a CUDA card or with
   fewer cards than the cell asks for;
2. set-up: builds the program from the configuration, makes its weights
   and draw-site seeds from --seed, feeds the traffic's set-up, and runs
   the checked mapping calls (timed as setup_s, from the process's start;
   its stages on standard error);
3. the window: units of the cell's work back to back for --seconds, then
   a synchronize; with --trace 1 also CUDA events around each unit, and
   after the window a traced segment of the traffic's trace_units units;
4. reads the peak device memory, frees the program, runs the plain
   reference and compares (checks.py) against benchmark/limits/<cell>.json;
5. reads the cell's metrics (end-to-end ones with --trace 0, per-layer
   ones with --trace 1), each by benchmark/metrics/<name>.py;
6. exits non-zero, and prints no result, where jax, jaxlib, flax or
   naruto_tpu has been loaded by then; else prints the result as the last
   line of standard output, the numbers compared beside their limits last
   on standard error and last in that line.

``--readings SEEDS`` (a comma list) prints the numbers compared for each
seed and no result: the program's (the default), the control's
(``--control``: the reference one step below the stated precisions,
in the program's place), or the
program's with a fault planted (``--fault state|half|stale``); the
limits are set from these. Where the cell's unit queries the map volumes,
each line also carries the volume numbers (checks.py).
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for _p in (ROOT, HERE):      # the program's package, then the benchmark's
    if _p not in sys.path:
        sys.path.insert(0, _p)
# what the run's process must not load, by whole top-level module name
FORBIDDEN = ("jax", "jaxlib", "flax", "naruto_tpu")


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def manifest(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell_entries(bench: dict, workload: str) -> dict:
    """The cell, its configuration entry and its metrics, by kind."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json: "
                         f"{sorted(cells)}")
    cell = cells[workload]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])

    def mine(metrics):
        return [m for m in metrics
                if workload in m.get("workloads", [workload])]

    return {"cell": cell, "config": config,
            "end_to_end": mine(bench["end_to_end"]),
            "per_layer": mine(bench["per_layer"])}


def reader(name: str, root: str = ROOT):
    """The read(run) function of benchmark/metrics/<name>.py."""
    path = os.path.join(root, "benchmark", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("metric_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_loaded() -> list:
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi: not read"


def open_cell(entries: dict, seed: int, device, tmp: str, root: str = ROOT,
              fault=None):
    import cells

    cfg = load_json(os.path.join(root, entries["config"]["file"]))["config"]
    traffic = load_json(os.path.join(root, "benchmark", "traffic",
                                     entries["cell"]["traffic"] + ".json"))
    return cells.kind(traffic["kind"], root)(cfg, traffic, seed, device,
                                              root, tmp, fault=fault)


def window(cell, seconds: float, trace: bool) -> SimpleNamespace:
    """Units of work back to back until `seconds` have passed, then a
    synchronize: all the work over all the time."""
    import torch

    cuda = cell.dev.type == "cuda"
    if trace and cuda:
        cell.events = []
    cell.work, cell.unit_s = 0, []
    cell.begin_window()
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        cell.unit()
    if cuda:
        torch.cuda.synchronize()
    out = SimpleNamespace(elapsed_s=time.perf_counter() - t0, work=cell.work,
                          unit_s=list(cell.unit_s),
                          unit_device_ms=cell.unit_device_ms(),
                          **cell.readings())
    cell.events = None
    return out


def measure(args, entries: dict, cell, tmp: str, root: str = ROOT) -> dict:
    """One timed (or traced) run of the opened cell: its result line."""
    import torch

    import checks
    import tracing

    cuda = cell.dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t_open = time.perf_counter()
    cell.setup()
    setup_s = time.perf_counter() - T_START
    stages, t = [f"imports {t_open - T_START:.3f}"], t_open
    for stage, at in cell.setup_marks:
        stages.append(f"{stage} {at - t:.3f}")
        t = at
    print(f"benchmark: set-up {setup_s:.3f} s: {', '.join(stages)}",
          file=sys.stderr)
    win = window(cell, args.seconds, bool(args.trace))
    trace = None
    if args.trace:
        n = cell.traffic["trace_units"]
        trace = tracing.record(lambda: [cell.unit() for _ in range(n)],
                               os.path.join(tmp, "trace.json"))
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    run = SimpleNamespace(kind=cell.traffic["kind"], units=cell.units,
                          cfg=cell.cfg, traffic=cell.traffic,
                          setup_s=setup_s, peak_bytes=peak, trace=trace,
                          **vars(win))
    cell.free()
    ref = cell.reference()
    numbers = checks.gaps(cell.obs, ref)
    limits = load_json(os.path.join(root, "benchmark", "limits",
                                    entries["cell"]["name"] + ".json"))
    group = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in entries[group]:
        v = reader(m["name"], root)(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": entries["cell"]["chips"], "memory_peak_bytes": peak}
    out = {"correct": checks.judge(numbers, limits),
           "attempted": run.work, "failed": 0, "metrics": metrics,
           "device": device}
    if trace is not None:
        device.update(busy_s=trace["busy_s"], window_s=trace["window_s"])
        out["breakdown"] = tracing.breakdown(trace)
    units = cell.units
    print(f"benchmark: {run.work} {units} in {run.elapsed_s:.6f} s, "
          f"{len(run.unit_s)} units timed", file=sys.stderr)
    out["checks"] = {k: {"value": numbers[k], "limit": v}
                     for k, v in limits.items()}
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']:.6e} limit {v['limit']:.3e}",
              file=sys.stderr)
    return out


def readings(args, entries: dict, device, tmp: str) -> None:
    """The numbers compared, a line a seed, for setting the limits."""
    import checks

    for seed in [int(s) for s in args.readings.split(",")]:
        cell = open_cell(entries, seed, device, tmp, fault=args.fault)
        t0 = time.perf_counter()
        if args.control:
            prog = cell.reference(control=True)
        else:
            cell.setup()
            prog = cell.obs
            cell.free()
        t1 = time.perf_counter()
        ref = cell.reference()
        mode = ("control" if args.control else
                f"fault:{args.fault}" if args.fault else "program")
        print(json.dumps({"seed": seed, "mode": mode, **checks.gaps(prog, ref),
                          **checks.detail(prog, ref),
                          "program_s": t1 - t0,
                          "reference_s": time.perf_counter() - t1}),
              flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--readings", default=None)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", choices=("state", "half", "stale"))
    args = ap.parse_args(argv)
    # the program's kernel caches, at fixed paths inside the checkout
    os.environ.setdefault("TRITON_CACHE_DIR",
                          os.path.join(ROOT, ".bench_cache", "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(ROOT, ".bench_cache", "torch_ext"))
    entries = cell_entries(manifest(), args.workload)
    import torch

    chips = entries["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    print(f"benchmark: card {card_line()}; peaks of an H100 SXM at 700 W",
          file=sys.stderr, flush=True)
    return run_cell(args, entries, "cuda")


def run_cell(args, entries: dict, device, opener=open_cell) -> int:
    """The run after the look for a card: the result line, printed only
    where nothing the run loaded, up to the line itself, is forbidden."""
    tmp = tempfile.mkdtemp(prefix="bench-")
    try:
        if args.readings:
            readings(args, entries, device, tmp)
            return 0
        out = measure(args, entries, opener(entries, args.seed, device, tmp),
                      tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    found = forbidden_loaded()
    if found:
        print(f"benchmark: the run loaded {found}; no result",
              file=sys.stderr, flush=True)
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
