"""Results-file merge/append (the port's own copy of
naruto_tpu/utils/results.py).

Parity with reference update_results_file (src/utils/general_utils.py:163-188):
a csv-ish two-line format (header line of metric names, value line) that is
merged when new metrics arrive for the same file.
"""
from __future__ import annotations

import os
from typing import Dict


def merge_seed_results(scene_dir: str,
                       out_name: str = "eval_summary.txt") -> str:
    """Merge per-seed eval_result.txt rows under scene_dir/seed_*/... into
    one table with mean/std rows (the reference's 5-trial protocol,
    scripts/naruto/run_replica.sh:24, reports per-seed metric rows that a
    human averages; this writes the merged table directly).

    Returns the summary path. Table format: header line, one row per seed,
    then mean and std rows."""
    import glob as _glob

    rows = []
    for seed_dir in sorted(_glob.glob(os.path.join(scene_dir, "seed_*"))):
        matches = _glob.glob(os.path.join(seed_dir, "**", "eval_result.txt"),
                             recursive=True)
        if not matches:
            continue
        with open(matches[0]) as f:
            lines = [ln.strip() for ln in f if ln.strip()]
        if len(lines) < 2:
            continue
        keys = lines[0].split(",")
        vals = [float(v) for v in lines[1].split(",")]
        rows.append((os.path.basename(seed_dir), dict(zip(keys, vals))))
    if not rows:
        raise FileNotFoundError(f"no seed_*/**/eval_result.txt under "
                                f"{scene_dir}")
    all_keys: list = []
    for _, r in rows:
        for k in r:
            if k not in all_keys:
                all_keys.append(k)
    out = os.path.join(scene_dir, out_name)
    with open(out, "w") as f:
        f.write("trial," + ",".join(all_keys) + "\n")
        cols = {k: [] for k in all_keys}
        for name, r in rows:
            f.write(name + "," + ",".join(
                f"{r[k]:.6f}" if k in r else "" for k in all_keys) + "\n")
            for k in all_keys:
                if k in r:
                    cols[k].append(r[k])
        import numpy as _np

        f.write("mean," + ",".join(
            f"{_np.mean(cols[k]):.6f}" if cols[k] else ""
            for k in all_keys) + "\n")
        f.write("std," + ",".join(
            f"{_np.std(cols[k]):.6f}" if cols[k] else ""
            for k in all_keys) + "\n")
    return out


def update_results_file(result_dict: Dict[str, float], filepath: str) -> None:
    existing: Dict[str, str] = {}
    if os.path.exists(filepath):
        with open(filepath) as f:
            lines = [ln.strip() for ln in f.readlines() if ln.strip()]
        if len(lines) >= 2:
            keys = lines[0].split(",")
            vals = lines[1].split(",")
            existing = dict(zip(keys, vals))
    for k, v in result_dict.items():
        existing[k] = f"{v:.6f}" if isinstance(v, float) else str(v)
    os.makedirs(os.path.dirname(os.path.abspath(filepath)), exist_ok=True)
    with open(filepath, "w") as f:
        f.write(",".join(existing.keys()) + "\n")
        f.write(",".join(existing.values()) + "\n")


def main(argv=None):
    """CLI: python -m naruto_tpu_torch.utils.results --scene-dir results/E/Replica/office0"""
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--scene-dir", required=True)
    args = p.parse_args(argv)
    out = merge_seed_results(args.scene_dir)
    with open(out) as f:
        print(f.read())


if __name__ == "__main__":
    main()
