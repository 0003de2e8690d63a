"""CLI: export the pose trajectory from a checkpoint to .npy (counterpart
of naruto_tpu/export_pose.py).

Parity with src/slam/export_pose.py:45-63 (dumps ckpt['pose'] to a stacked
[N, 4, 4] array). Reads the npz checkpoints of either package
(utils/ckpt_io.py); the JAX package's older pickle checkpoints are refused.

    python -m naruto_tpu_torch.export_pose --ckpt ckpt_final.pkl --out poses.npy
"""
from __future__ import annotations

import argparse

import numpy as np

from naruto_tpu_torch.utils import ckpt_io


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--num", type=int, default=None,
                   help="only export the first N poses")
    args = p.parse_args(argv)

    if ckpt_io.is_legacy_pickle(args.ckpt):
        raise SystemExit(
            f"{args.ckpt} is a pickle checkpoint (the JAX package's format "
            "before its npz checkpoints); the port reads only the npz "
            "format of utils/ckpt_io.py: export it with the JAX package's "
            "export_pose")
    arrays, _ = ckpt_io.load_arrays(args.ckpt)
    key = [k for k in arrays if k.rstrip("]'").endswith("poses")]
    if not key:
        raise KeyError(f"no poses leaf in {args.ckpt}: {list(arrays)}")
    poses = np.asarray(arrays[key[0]])
    if args.num:
        poses = poses[:args.num]
    np.save(args.out, poses)
    print(f"exported {len(poses)} poses to {args.out}")


if __name__ == "__main__":
    main()
