"""CLI entry point of the port: run a reconstruction on one torch device
(counterpart of naruto_tpu/run.py).

Surface parity with the reference entry (src/naruto/cfg_loader.py:57-76 /
src/naruto/main.py): `--cfg` YAML experiment file (or `--dataset --scene`
preset), `--seed`, `--result_dir`, `--num_iter`, `--enable_vis`, and the
JAX CLI's `--sim`, `--scene_path` and `--resume`. The JAX CLI's
`--platform` is `--device` here (default cuda; `--device cpu` runs on the
host).

    python -m naruto_tpu_torch.run --cfg configs/Replica/office0/naruto.yaml
    python -m naruto_tpu_torch.run --cfg configs/ab/passive_traj_ab.yaml
    python -m naruto_tpu_torch.run --sim raycast --scene_path mesh.ply
    python -m naruto_tpu_torch.run --cfg ... --resume auto
    python -m naruto_tpu_torch.run --cfg ... --enable_vis 1

The first is the active loop (simulate -> map -> plan, the default), the
second the passive protocol over a recorded trajectory, both on the
analytic simulator; the third the active loop on a scene mesh through the
raycast simulator (make one with `python -m
naruto_tpu_torch.scripts.make_scene_assets`); the fourth continues a run
from the full-state snapshot its `general.ckpt_freq` wrote in the run
directory (`auto`; or give a snapshot's path), or starts fresh when there
is none; the fifth also writes every step's artifacts (rgbd panels, poses,
planner state, periodic meshes) under the run's `visualization/`, which
`python -m naruto_tpu_torch.visualization.offline` turns into plots,
stills and videos. `--sim replay --scene_path DIR` replays recorded frames
(`python -m naruto_tpu_torch.sim.scripted` writes them).

Data-parallel, one process per rank under torchrun, with the YAML's
`parallel: {shard_rays: true, shard_volumes: true}` (the JAX package's
switches; there is no flag for them):

    torchrun --nproc_per_node 2 -m naruto_tpu_torch.run --cfg sharded.yaml

Every rank runs the same loop; the first line says the ranks, the backend
and why (parallel/mesh.py), and rank 0 alone prints and writes the run's
files.
"""
from __future__ import annotations

import argparse
import os
import time

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="NARUTO-TPU reconstruction, PyTorch port")
    p.add_argument("--cfg", type=str, default=None,
                   help="YAML experiment config (with inherit_from support)")
    p.add_argument("--dataset", type=str, default="Replica")
    p.add_argument("--scene", type=str, default="office0")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--result_dir", type=str, default=None)
    p.add_argument("--num_iter", type=int, default=None)
    p.add_argument("--enable_vis", type=int, default=0,
                   help="save the per-step artifacts (vis.enable_all_vis "
                        "and vis.vis_rgbd)")
    p.add_argument("--sim", type=str, default=None,
                   help="simulator backend override (analytic|replay|"
                        "raycast)")
    p.add_argument("--scene_path", type=str, default=None,
                   help="scene asset path (sim.scene_path)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the run (default cuda; cpu runs on "
                        "the host)")
    p.add_argument("--resume", type=str, default=None,
                   help="full-state snapshot to resume from ('auto' = the "
                        "run dir's full_state_latest.pkl; requires "
                        "general.ckpt_freq > 0 to have written one)")
    return p.parse_args(argv)


def build_config(args):
    from naruto_tpu_torch.config import load_config, make_config
    from naruto_tpu_torch.config.schema import deep_update

    if args.cfg:
        cfg = load_config(args.cfg)
    else:
        cfg = make_config(args.dataset, args.scene, seed=args.seed,
                          num_iter=args.num_iter)
    over = {"general": {"seed": args.seed}}
    if args.num_iter is not None:
        over["general"]["num_iter"] = args.num_iter
    if args.result_dir:
        over["general"]["result_dir"] = args.result_dir
    if args.enable_vis:
        # mirrors the reference --enable_vis: artifact saving plus the live
        # rgbd window, which the port does not open (visualization/saver.py)
        over["vis"] = {"enable_all_vis": True, "vis_rgbd": True}
    if args.sim:
        over["sim"] = {"method": args.sim}
    if args.scene_path:
        over.setdefault("sim", {})["scene_path"] = args.scene_path
    return deep_update(cfg, over)


def resume_path(args, run_dir: str):
    """The snapshot --resume names ('auto': the run directory's, when there
    is one), or None."""
    if args.resume != "auto":
        return args.resume
    from naruto_tpu_torch.system.engine import SNAPSHOT_NAME

    path = os.path.join(run_dir, SNAPSHOT_NAME)
    if os.path.exists(path):
        return path
    print(f"[resume] no snapshot at {path}; starting fresh", flush=True)
    return None


def main(argv=None):
    args = parse_args(argv)
    from naruto_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(args.device)
    lead = mesh is None or mesh.rank == 0
    if mesh is not None and lead:
        print(mesh.describe(), flush=True)
    try:
        _run(args, mesh.device if mesh is not None else args.device, lead)
    finally:
        if mesh is not None:
            torch.distributed.destroy_process_group()


def _run(args, device, lead: bool) -> None:
    cfg = build_config(args)
    from naruto_tpu_torch.system.engine import Engine

    engine = Engine(cfg, device=device)
    resume = resume_path(args, engine.run_dir) if args.resume else None
    dev = engine.device
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    engine.run(resume_from=resume)
    if on_card:
        torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    engine.finalize()
    if on_card:
        torch.cuda.synchronize(dev)
    t2 = time.perf_counter()
    peak = (f", peak device memory "
            f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.3f} GiB"
            if on_card else "")
    if lead:
        print(f"[run] wall: run() {t1 - t0:.2f} s, finalize() "
              f"{t2 - t1:.2f} s{peak}", flush=True)


if __name__ == "__main__":
    main()
