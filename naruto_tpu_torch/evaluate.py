"""CLI: evaluate a finished run (recon metrics, MAD, trajectory length);
the port's counterpart of naruto_tpu/evaluate.py.

Pipeline parity with scripts/evaluation/eval_replica.sh: cull the
reconstructed mesh with the run's trajectory, compute accuracy/completion/
ratio against the ground-truth mesh, MAD from the checkpoint (either
package's save_ckpt file), trajectory length, and append everything to
eval_result.txt. The MAD's field queries run on `--device` (default cuda).

    python -m naruto_tpu_torch.evaluate --rec mesh_final.ply --gt gt.ply \
        --ckpt ckpt_final.pkl --dataset Replica --scene office0
"""
from __future__ import annotations

import argparse
import json

import torch


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--rec", required=True,
                   help="reconstructed mesh (ply, glb or gltf)")
    p.add_argument("--gt", required=True,
                   help="ground-truth mesh (ply, glb or gltf)")
    p.add_argument("--ckpt", default=None, help="mapper checkpoint (pkl)")
    p.add_argument("--dataset", default="Replica")
    p.add_argument("--scene", default="office0")
    p.add_argument("--out", default=None, help="eval_result.txt path")
    p.add_argument("--cull", action="store_true",
                   help="frustum-cull the rec mesh with ckpt poses first")
    p.add_argument("--align", action="store_true", help="ICP align first")
    p.add_argument("--n_samples", type=int, default=200_000)
    p.add_argument("--device", default="cuda",
                   help="torch device of the MAD field queries (default "
                        "cuda; cpu runs them on the host)")
    args = p.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA device and none is "
                           "available; pass --device cpu to run on the host")

    from naruto_tpu_torch.config import make_config
    from naruto_tpu_torch.evaluation import (
        cull_mesh, eval_mad, eval_mesh, eval_traj_length,
    )
    from naruto_tpu_torch.mesh.ply import read_mesh
    from naruto_tpu_torch.utils.results import update_results_file

    cfg = make_config(args.dataset, args.scene)
    rec_v, rec_f, _ = read_mesh(args.rec)
    gt_v, gt_f, _ = read_mesh(args.gt)

    results = {}
    mapper = None
    if args.ckpt:
        from naruto_tpu_torch.mapping.mapper import Mapper
        from naruto_tpu_torch.utils import ckpt_io

        # the pose table as long as the checkpoint's: it follows the run's
        # general.num_iter, which need not be the preset's
        arrays, _ = ckpt_io.load_arrays(args.ckpt)
        n_poses = len(arrays["['poses']"])
        mapper = Mapper(make_config(args.dataset, args.scene,
                                    num_iter=n_poses - 1),
                        device=args.device)
        mapper.load_ckpt(args.ckpt)
        poses = mapper.poses.cpu().numpy()
        if mapper.step > 0:           # drop unused trailing identity poses
            poses = poses[:mapper.step + 1]
        results["traj_length_m"] = eval_traj_length(poses)
        if args.cull:
            rec_v, rec_f = cull_mesh(
                rec_v, rec_f, list(poses), cfg.cam.intrinsics,
                (cfg.cam.H, cfg.cam.W), depth_fn=None, subsample=10)

    results.update(eval_mesh(rec_v, rec_f, gt_v, gt_f,
                             n_samples=args.n_samples, align=args.align))
    if mapper is not None:
        results["mad_cm"] = eval_mad(mapper, gt_v, gt_f,
                                     n_samples=args.n_samples)

    print(json.dumps(results))
    if args.out:
        update_results_file(results, args.out)


if __name__ == "__main__":
    main()
