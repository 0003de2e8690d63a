"""The eager BA call of several checkouts of this repository, timed in turns
on one card. The eager call (`Mapper._ba_impl_eager`; `Mapper._ba_impl`
itself in a checkout without the BA graph) is the form of the sharded BA,
whose ranks run it on the host's pace.

    python -m naruto_tpu_torch.scripts.eager_turns --trees DIR [DIR ...]
        [--rounds 2] [--steps 10] [--windows 3] [--settle 3] [--out FILE]

Each round runs one child process per tree, in the given order in even
rounds and in the reverse order in odd ones (A B, B A: a drift of the
host falls on every tree alike). A child runs with the tree as its
working directory and first on sys.path, builds the tree's kernels, and
  * times bench's workload (office0 at full width, 22 keyframes, bucket
    512) through the tree's `bench._Row` with its eager call: `--settle`
    untimed BA steps, then `--windows` windows of `--steps` BA steps, the
    iters/s of each;
  * runs the tree's `chip_smoke.py` phase 14 (`run_sharded`: the
    data-parallel BA on 2 ranks sharing the card, each running the eager
    call) and reads from its log the BA iteration wall on 1 rank and on
    rank 0 of 2, and each rank's iteration with every collective timed
    alone.
Prints each child's readings as one JSON line, then one JSON line of the
medians by tree, and writes all of it to `--out`. It needs a card.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

CHILD_TIMEOUT_S = 900


def _child(tree: str, steps: int, windows: int, settle: int) -> None:
    """One tree's readings, as one JSON line on stdout."""
    sys.path.insert(0, tree)
    import contextlib
    import inspect
    import io
    import re

    import torch

    import chip_smoke
    from naruto_tpu_torch import bench
    from naruto_tpu_torch.config import make_config
    from naruto_tpu_torch.ops import kernels, primitives

    kernels.build()
    dev = torch.device("cuda")
    eager = "eager" in inspect.signature(bench._Row).parameters
    row = bench._Row(make_config("Replica", "office0"), dev, settle,
                     **({"eager": True} if eager else {}))
    for _ in range(windows):
        row.window(steps)
    out = {"tree": tree, "row": "eager=True" if eager else "_ba_impl",
           "bucket": row.bucket,
           "iters_per_sec": [round(w, 2) for w in row.windows]}
    del row
    torch.cuda.empty_cache()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        chip_smoke.run_sharded(torch, kernels, primitives, tree)
    text = log.getvalue()
    print(text, file=sys.stderr, flush=True)
    one, two = re.search(r"BA iteration wall: 1 rank ([\d.]+) ms, \d+ ranks "
                         r"([\d.]+) ms", text).groups()
    out.update(one_rank_ms=float(one), two_rank_ms=float(two),
               site_iter_ms=[float(v) for v in re.findall(
                   r"timed alone .*?an iteration ([\d.]+) ms", text)])
    print(json.dumps(out), flush=True)


def _medians(results: list) -> dict:
    by_tree = {}
    for res in results:
        by_tree.setdefault(res["tree"], []).append(res)
    return {tree: {
        "iters_per_sec": statistics.median(
            w for r in runs for w in r["iters_per_sec"]),
        "one_rank_ms": statistics.median(r["one_rank_ms"] for r in runs),
        "two_rank_ms": statistics.median(r["two_rank_ms"] for r in runs),
        "runs": len(runs)} for tree, runs in by_tree.items()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+",
                    help="checkouts of this repository, each timed in turn")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--steps", type=int, default=10,
                    help="BA steps a timed window")
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--settle", type=int, default=3,
                    help="untimed BA steps before the windows")
    ap.add_argument("--out", help="JSON file of every reading")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        _child(**json.loads(args.child))
        return
    if not args.trees:
        ap.error("--trees is required")

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("eager_turns needs a CUDA device")
    trees = [os.path.abspath(t) for t in args.trees]
    results = []
    for r in range(args.rounds):
        for tree in (trees if r % 2 == 0 else trees[::-1]):
            spec = json.dumps({"tree": tree, "steps": args.steps,
                               "windows": args.windows,
                               "settle": args.settle})
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child", spec],
                cwd=tree, env={**os.environ, "PYTHONPATH": tree},
                capture_output=True, text=True, timeout=CHILD_TIMEOUT_S)
            if proc.returncode != 0:
                sys.stderr.write(proc.stderr[-6000:])
                raise SystemExit(f"the child for {tree} (round {r}) exited "
                                 f"with {proc.returncode}")
            res = {**json.loads(proc.stdout.strip().splitlines()[-1]),
                   "round": r}
            print(json.dumps(res), flush=True)
            results.append(res)
    summary = _medians(results)
    print(json.dumps({"medians": summary}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"runs": results, "medians": summary}, f, indent=1)


if __name__ == "__main__":
    main()
