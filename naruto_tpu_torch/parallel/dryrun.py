"""Multi-rank runs of the production mapper, and the rank worker that
launches them (counterparts of __graft_entry__.py's tiny_mapper_config and
dryrun_multichip, without jax).

``spawn`` starts one process per rank as torchrun would (WORLD_SIZE, RANK
and LOCAL_RANK in each one's environment) running this module, which joins
the process group through a ``file://`` rendezvous in a work directory
(no port to take), runs the target function ``module:function`` on the
rank's mesh and the payload, and saves what it returns. The target's
module is imported in every rank, so it must import neither jax nor a test
file. A rank that fails ends the others and makes ``spawn`` raise with its
output; nothing goes on past a failed rank. The ranks run on the card
(those beyond the cards share cuda:0) unless the caller asks for the CPU:

    python -c "from naruto_tpu_torch.parallel.dryrun import \\
        dryrun_multichip; dryrun_multichip(2)"                # the card
    python -c "from naruto_tpu_torch.parallel.dryrun import \\
        dryrun_multichip; dryrun_multichip(2, device='cpu')"  # the host
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time
from typing import Any, List, Optional

import numpy as np
import torch

from naruto_tpu_torch.parallel.sharded import (sharded_grad_step,
                                               sharded_volume_query,
                                               tree_leaves)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def tiny_mapper_config(n_devices: int = 8):
    """__graft_entry__.py's full-featured tiny mapper config (active rays,
    uncertainty grid, smoothness, keyframe DB, bucketed current block) with
    the ray and voxel axes sharded."""
    from naruto_tpu_torch.config import make_config

    return make_config("Replica", "office0", overrides={
        "cam": {"H": 24, "W": 32, "fx": 16.0, "fy": 16.0,
                "cx": 15.5, "cy": 11.5, "far": 2.0},
        "sim": {"pinhole_hw": (24, 32), "erp_hw": (16, 32)},
        "grid": {"hash_size": 12, "n_levels": 4, "base_resolution": 8,
                 "voxel_sdf": 0.05},
        "decoder": {"hidden_dim": 16, "hidden_dim_color": 16},
        "training": {"n_range_d": 5, "n_samples_d": 8, "smooth_pts": 8},
        "mapper": {
            "bound": ((-1.0, 1.0), (-1.0, 1.0), (-1.0, 1.0)),
            "marching_cubes_bound": ((-1.0, 1.0), (-1.0, 1.0), (-1.0, 1.0)),
            "voxel_size": 0.25, "sample": 64, "iters": 2, "first_iters": 4,
            "min_pixels_cur": 8, "act_ray_num_uncert_sample": 16,
        },
        "general": {"num_iter": 100},
        "parallel": {"shard_rays": True, "shard_volumes": True,
                     "mesh_shape": (n_devices,)},
    })


# ---------------------------------------------------------------- spawning
def spawn(target: str, world: int, payload: Any = None, device: str = "cuda",
          timeout: float = 600.0, workdir: Optional[str] = None) -> List:
    """Run ``target`` ("module:function", called as fn(mesh, payload)) on
    `world` ranks, each a process of its own on `device` (ranks beyond the
    cards share cuda:0); returns the ranks' results in rank order. Raises
    with a rank's output when it fails or the ranks outlive `timeout`."""
    from naruto_tpu_torch.parallel.mesh import rank_device

    rank_device(device, world, 0)       # no rank starts without its device
    own = workdir is None
    tmp = tempfile.TemporaryDirectory(prefix="ranks_") if own else None
    work = tmp.name if own else workdir
    torch.save(payload, os.path.join(work, "payload.pt"))
    procs, logs = [], []
    try:
        for rank in range(world):
            env = dict(os.environ, WORLD_SIZE=str(world), RANK=str(rank),
                       LOCAL_RANK=str(rank))
            logs.append(open(os.path.join(work, f"rank{rank}.log"), "w+"))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "naruto_tpu_torch.parallel.dryrun",
                 "--target", target, "--workdir", work, "--device", device],
                env=env, cwd=ROOT, stdout=logs[-1],
                stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.poll()]
            if bad or time.monotonic() > deadline:
                for p in procs:
                    p.kill()
                for p in procs:
                    p.wait()
                why = (f"rank {bad[0]} exited with {procs[bad[0]].returncode}"
                       if bad else f"the ranks outlived {timeout} s")
                raise RuntimeError(f"{target} on {world} ranks: {why}\n"
                                   + _tail(logs[bad[0] if bad else 0]))
            time.sleep(0.05)
        bad = [r for r, p in enumerate(procs) if p.returncode]
        if bad:
            raise RuntimeError(f"{target} on {world} ranks: rank {bad[0]} "
                               f"exited with {procs[bad[0]].returncode}\n"
                               + _tail(logs[bad[0]]))
        for r, f in enumerate(logs):
            out = _tail(f, 100_000).strip()
            if out:
                print(f"[rank {r}] " + out.replace("\n", f"\n[rank {r}] "),
                      flush=True)
        return [torch.load(os.path.join(work, f"result{r}.pt"),
                           weights_only=False) for r in range(world)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
        if tmp is not None:
            tmp.cleanup()


def _tail(f, n: int = 6000) -> str:
    f.flush()
    f.seek(0)
    return f.read()[-n:]


def _worker(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--target", required=True)
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--device", required=True)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    import importlib

    from naruto_tpu_torch.parallel.mesh import make_mesh

    rendezvous = os.path.join(args.workdir, "rendezvous")
    mesh = make_mesh(args.device, init_method=f"file://{rendezvous}")
    mod, fn = args.target.split(":")
    payload = torch.load(os.path.join(args.workdir, "payload.pt"),
                         weights_only=False)
    try:
        out = getattr(importlib.import_module(mod), fn)(mesh, payload)
        torch.save(out, os.path.join(
            args.workdir, f"result{mesh.rank if mesh else 0}.pt"))
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


# ------------------------------------------------------------------ targets
def to_host(tree):
    """A copy of a tree of tensors (dicts, lists, tuples) on the host, its
    sequences as lists; other leaves as they are."""
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_host(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    return tree


def grads_target(mesh, payload) -> dict:
    """payload["mappers"]: for each (a mapper's "cfg" and "params", and
    "calls": the per-ray arguments of Mapper._grad_fn for the full batch,
    with its "smooth" and "importance_u" draws) the gradients, aux and
    collectives of each call, then the volume query and its collectives.
    payload["functions"]: sharded_grad_step and sharded_volume_query of
    its "spec", "rc", "lw" and "params" on its "args" and "x01"."""
    from naruto_tpu_torch.mapping.mapper import Mapper
    from naruto_tpu_torch.parallel.mesh import (collective_counts,
                                                reset_collective_counts)
    from naruto_tpu_torch.utils.ckpt_io import to_torch

    mappers = []
    for case in payload["mappers"]:
        mapper = Mapper(case["cfg"], device=mesh.device)
        mapper.load_weights(case["params"])
        out = {"sharded": mapper._ba_mesh is not None, "calls": []}
        for call in case["calls"]:
            reset_collective_counts()
            aux, grads = mapper._grad_fn(
                *[a.to(mesh.device) for a in call["args"]],
                smooth=call.get("smooth"),
                importance_u=call.get("importance_u"))
            out["calls"].append({"aux": to_host(aux), "grads": to_host(grads),
                                 "collectives": collective_counts()})
        reset_collective_counts()
        u, s = mapper.map_volumes()
        out["volumes"] = (u.cpu(), s.cpu())
        out["volume_collectives"] = collective_counts()
        mappers.append(out)
    fn = payload["functions"]
    params = to_torch(fn["params"], mesh.device)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    (loss, _), grads = sharded_grad_step(mesh, fn["spec"], fn["rc"], fn["lw"])(
        params, *[a.to(mesh.device) for a in fn["args"]])
    sdf, um = sharded_volume_query(mesh, fn["spec"])(
        params, fn["x01"].to(mesh.device))
    return {"mappers": mappers, "functions": {
        "loss": float(loss), "grads": to_host(grads),
        "volumes": (sdf.cpu(), um.cpu())}}


def run_target(mesh, argv) -> None:
    """``python -m naruto_tpu_torch.run`` with `argv` on this rank, as under
    torchrun (the process group already joined)."""
    from naruto_tpu_torch import run

    run.main(argv)


def dryrun_target(mesh, payload) -> dict:
    """__graft_entry__.py's dryrun on this rank: the first frame and the
    BA through frame 5 on a constant frame, then the active engine loop for
    payload["num_iter"] steps writing under payload["result_dirs"][rank]."""
    from naruto_tpu_torch.config.schema import deep_update
    from naruto_tpu_torch.mapping.mapper import Mapper
    from naruto_tpu_torch.system.engine import Engine

    cfg = tiny_mapper_config(mesh.world)
    mapper = Mapper(cfg, device=mesh.device)
    if mapper._ba_mesh is None or mapper._sharded_vol is None:
        raise RuntimeError("the sharded BA or volume path is not active")
    color = np.full((mapper.H, mapper.W, 3), 0.5, np.float32)
    depth = np.full((mapper.H, mapper.W), 1.2, np.float32)
    c2w = np.eye(4, dtype=np.float32)
    for i in range(6):
        vols = mapper.online_recon_step(i, color, depth, c2w)
        if vols is not None and not torch.isfinite(vols[1]).all():
            raise RuntimeError(f"non-finite sdf volume at frame {i}")
    first = {"params": to_host(mapper.params), "sdf": vols[1].cpu()}
    ecfg = deep_update(cfg, {"general": {
        "num_iter": payload["num_iter"], "seed": 0,
        "result_dir": payload["result_dirs"][mesh.rank]}})
    engine = Engine(ecfg, device=mesh.device, quiet=True)
    if engine.mapper._ba_mesh is None:
        raise RuntimeError("the engine's mapper is not sharded")
    final = engine.run()
    stats = dict(engine.planner.stats)
    stats.pop("events", None)
    return {"first": first, "final_c2w": final,
            "poses": engine.mapper.poses.cpu(),
            "params": to_host(engine.mapper.params), "planner": stats,
            "lead": engine.lead}


def dryrun_multichip(n_ranks: int, device: str = "cuda", num_iter: int = 50,
                     result_dir: Optional[str] = None) -> List[dict]:
    """The production mapper data-parallel over n_ranks ranks: first-frame
    mapping and the bucketed global BA with active rays, the keyframe DB,
    the three optimizer groups and the uncertainty-grid cadence (rays
    sharded in Mapper._grad_fn, voxels in the volume query), then
    `num_iter` steps of the active engine loop (analytic sim -> sharded
    mapper -> planner). Rank r writes under <result_dir>/rank<r> (only
    rank 0 writes anything). Raises unless every rank ends with the same
    field, poses and final pose; returns the ranks' results."""
    tmp = None
    if result_dir is None:
        tmp = tempfile.TemporaryDirectory(prefix="dryrun_engine_")
        result_dir = tmp.name
    try:
        res = spawn("naruto_tpu_torch.parallel.dryrun:dryrun_target",
                    n_ranks, {"num_iter": num_iter, "result_dirs": [
                        os.path.join(result_dir, f"rank{r}")
                        for r in range(n_ranks)]}, device=device)
    finally:
        if tmp is not None:
            tmp.cleanup()
    ref = res[0]
    for r, got in enumerate(res[1:], 1):
        for what in ("first", "final"):
            a = tree_leaves(ref["params"] if what == "final"
                        else ref["first"]["params"])
            b = tree_leaves(got["params"] if what == "final"
                        else got["first"]["params"])
            if not all(torch.equal(x, y) for x, y in zip(a, b)):
                raise RuntimeError(f"rank {r}'s field after the "
                                   f"{what} phase differs from rank 0's")
        if not (torch.equal(got["poses"], ref["poses"]) and np.array_equal(
                got["final_c2w"], ref["final_c2w"])):
            raise RuntimeError(f"rank {r}'s poses differ from rank 0's")
    sdf = ref["first"]["sdf"]
    print(f"dryrun_multichip({n_ranks}) OK: production BA step on "
          f"{n_ranks} ranks; sdf_vol range [{float(sdf.min()):.3f}, "
          f"{float(sdf.max()):.3f}]; {num_iter}-step engine loop, "
          f"planner stats {ref['planner']}; field and poses bit-identical "
          f"across ranks", flush=True)
    return res


if __name__ == "__main__":
    _worker()
