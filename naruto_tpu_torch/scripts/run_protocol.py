"""The multi-scene, multi-seed protocol runner (the port's counterpart of
scripts/run_{replica,mp3d,naruto}.sh, without jax): ``naruto_tpu_torch.run``
for each (scene, seed), each under a time limit, then the per-seed rows of
each scene merged into ``eval_summary.txt`` (mean and std rows) with
``naruto_tpu_torch.utils.results``.

    python -m naruto_tpu_torch.scripts.run_protocol replica office0 1 EXP1
    python -m naruto_tpu_torch.scripts.run_protocol replica all 5 EXP1 raycast
    python -m naruto_tpu_torch.scripts.run_protocol naruto all 1 EXP1 \\
        raycast /data --timeout 3600

The positional arguments are the shell scripts': dataset, scene (or
``all``), trials, experiment name, simulator, data directory. Seeds and
scene lists are theirs; trial i runs seed SEEDS[i] (the NARUTO list has
one seed, and trial i > 0 runs seed 500 i, as run_naruto.sh). Run i of a
scene writes ``results/<exp>/<Dataset>/<scene>/seed_<seed>``. A raycast
run takes the scene mesh from the data directory (``<dir>/<scene>/
mesh.ply``, or ``mesh.glb`` for NARUTO) and, without one, synthesises it
once per scene with ``naruto_tpu_torch.scripts.make_scene_assets`` under
``results/<exp>/assets/``. A run that fails or outlives ``--timeout``
seconds (a seed caught in the collision livelock spends ~50 s of host RRT
on each plan) is reported as failed, the others go on, and the runner
exits with status 1.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
from typing import Dict, List, NamedTuple, Optional, Sequence


class Protocol(NamedTuple):
    dataset: str
    scenes: Sequence[str]
    seeds: Sequence[int]
    default_scene: str
    mesh_names: Sequence[str]     # scene meshes looked up in the data dir
    merge: bool                   # merge per-seed rows (run_mp3d.sh does not)


PROTOCOLS: Dict[str, Protocol] = {
    # run_replica.sh:15-16 (the reference's trial seeds, run_replica.sh:24)
    "replica": Protocol(
        "Replica", ("office0", "office1", "office2", "office3", "office4",
                    "room0", "room1", "room2"),
        (0, 500, 1000, 1500, 1999), "office0", ("mesh.ply",), True),
    # run_mp3d.sh:11-12
    "mp3d": Protocol(
        "MP3D", ("GdvgFV5R1Z5", "HxpKQynjfin", "YmJkqBEsHnH", "gZ6f7yhEvPG",
                 "pLe4wQe7qrG"),
        (0, 500, 1000, 1500, 1999), "gZ6f7yhEvPG", ("mesh.ply",), False),
    # run_naruto.sh:17-18
    "naruto": Protocol(
        "NARUTO", ("naruto", "jiraiya", "hokage_room"), (0,), "naruto",
        ("mesh.ply", "mesh.glb"), True),
}


def trial_seed(proto: Protocol, i: int) -> int:
    if i < len(proto.seeds):
        return proto.seeds[i]
    if proto.dataset == "NARUTO":
        return i * 500
    raise ValueError(f"{proto.dataset} has {len(proto.seeds)} trial seeds; "
                     f"trial {i} has none")


def scene_mesh(proto: Protocol, scene: str, data_dir: str, exp_dir: str,
               asset_args: Sequence[str] = ()) -> str:
    """The raycast scene mesh: the data directory's, else one synthesised
    from the analytic scene (once per scene)."""
    if data_dir:
        for name in proto.mesh_names:
            path = os.path.join(data_dir, scene, name)
            if os.path.isfile(path):
                return path
        raise FileNotFoundError(
            f"no {'/'.join(proto.mesh_names)} under "
            f"{os.path.join(data_dir, scene)}")
    fmt = proto.mesh_names[-1].rsplit(".", 1)[1]
    path = os.path.join(exp_dir, "assets", proto.dataset, scene,
                        f"mesh.{fmt}")
    if not os.path.isfile(path):
        cmd = [sys.executable, "-m",
               "naruto_tpu_torch.scripts.make_scene_assets",
               "--dataset", proto.dataset, "--scene", scene,
               "--format", fmt, "--out", path, *asset_args]
        print(f"=== synthesising {proto.dataset}/{scene} -> {path}",
              flush=True)
        subprocess.run(cmd, check=True)
    return path


def run_protocol(name: str, scene: str = "", num_trials: int = 1,
                 exp: str = "default", sim: str = "analytic",
                 data_dir: str = "", timeout: Optional[float] = None,
                 results_root: str = "results",
                 run_args: Sequence[str] = (),
                 asset_args: Sequence[str] = ()) -> List[str]:
    """Run the protocol; returns the failed runs' descriptions (empty when
    every run ended well). run_args are appended to every
    ``naruto_tpu_torch.run`` command and asset_args to every
    ``make_scene_assets`` one (the tests give a small config and the
    host)."""
    proto = PROTOCOLS[name]
    scene = scene or proto.default_scene
    scenes = list(proto.scenes) if scene == "all" else [scene]
    exp_dir = os.path.join(results_root, exp)
    failed = []
    for sc in scenes:
        mesh = (scene_mesh(proto, sc, data_dir, exp_dir, asset_args)
                if sim == "raycast" else None)
        for i in range(num_trials):
            seed = trial_seed(proto, i)
            result_dir = os.path.join(exp_dir, proto.dataset, sc,
                                      f"seed_{seed}")
            cmd = [sys.executable, "-m", "naruto_tpu_torch.run",
                   "--dataset", proto.dataset, "--scene", sc,
                   "--seed", str(seed), "--result_dir", result_dir,
                   "--sim", sim, *(["--scene_path", mesh] if mesh else []),
                   *run_args]
            tag = f"{proto.dataset}/{sc} seed={seed}"
            print(f"=== {tag} -> {result_dir}", flush=True)
            try:
                rc = subprocess.run(cmd, timeout=timeout).returncode
            except subprocess.TimeoutExpired:
                failed.append(f"{tag}: timed out after {timeout} s")
                print(f"=== FAILED {failed[-1]}", flush=True)
                continue
            if rc != 0:
                failed.append(f"{tag}: exit status {rc}")
                print(f"=== FAILED {failed[-1]}", flush=True)
    if proto.merge:
        from naruto_tpu_torch.utils.results import merge_seed_results

        for sc in scenes:
            scene_dir = os.path.join(exp_dir, proto.dataset, sc)
            try:
                out = merge_seed_results(scene_dir)
            except FileNotFoundError as e:
                print(f"=== no rows to merge: {e}", flush=True)
                continue
            with open(out) as f:
                print(f.read(), flush=True)
    return failed


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("protocol", choices=sorted(PROTOCOLS))
    p.add_argument("scene", nargs="?", default="",
                   help="a scene of the protocol, or all (default: the "
                        "shell script's)")
    p.add_argument("num_trials", nargs="?", type=int, default=1)
    p.add_argument("exp", nargs="?", default="default")
    p.add_argument("sim", nargs="?", default="analytic")
    p.add_argument("data_dir", nargs="?", default="")
    p.add_argument("--timeout", type=float, default=None,
                   help="seconds each run may take; a run cut there is "
                        "reported as failed")
    args = p.parse_args(argv)
    failed = run_protocol(args.protocol, args.scene, args.num_trials,
                          args.exp, args.sim, args.data_dir, args.timeout)
    if failed:
        print(f"{len(failed)} run(s) failed:\n  " + "\n  ".join(failed),
              flush=True)
        sys.exit(1)


if __name__ == "__main__":
    main()
