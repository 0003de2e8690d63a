"""Where the reconstruction is incomplete: the ground-truth surface samples
farther than the completion-ratio threshold (5 cm, as
evaluation/recon.py) from the reconstruction, clustered by connected voxel
components, each with its centroid in world and voxel coordinates so that
the clusters can be read against the goals of planner_stats.json (the
port's counterpart of scripts/completion_gaps.py, without jax).

    python -m naruto_tpu_torch.scripts.completion_gaps \\
        --run results/EXP/Replica/office0/seed_500/Replica/office0 \\
        [--gt mesh.ply] [--rec mesh.ply] [--thresh 0.05] [--voxel 0.2]

The ground truth is --gt, else the mesh of the run's config.json
sim.scene_path (a raycast run writes no gt_mesh.ply), else the run's
gt_mesh.ply; without any of them it raises, naming every path it tried.
The reconstruction is --rec, else the run's last mesh_*_final.ply, else
its last periodic mesh/mesh_*.ply. The samples are drawn as the JAX
script draws them (default_rng(0), ground truth first), so both print the
same ratio and clusters for one run.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import List, Optional

import numpy as np


def scene_path_candidates(scene_path: str) -> List[str]:
    """The ground-truth meshes a sim.scene_path names, in the engine's
    order: the path itself when it is a mesh file, else mesh.ply / mesh.glb
    in the directory."""
    if not scene_path:
        return []
    if scene_path.lower().endswith((".ply", ".glb", ".gltf")):
        return [scene_path]
    return [os.path.join(scene_path, n) for n in ("mesh.ply", "mesh.glb")]


def ground_truth_path(run: str, gt: Optional[str] = None) -> str:
    """--gt, else the run's scene_path mesh, else its gt_mesh.ply."""
    tried = []
    if gt is not None:
        tried.append(gt)
    else:
        cfg_path = os.path.join(run, "config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                scene = json.load(f).get("sim", {}).get("scene_path", "")
            tried += scene_path_candidates(scene)
        tried.append(os.path.join(run, "gt_mesh.ply"))
    for path in tried:
        if os.path.isfile(path):
            return path
    raise FileNotFoundError(
        "no ground-truth mesh; tried " + ", ".join(tried)
        + " (pass --gt, or run with sim.scene_path set to the scene mesh)")


def recon_path(run: str, rec: Optional[str] = None) -> str:
    if rec is not None:
        return rec
    for pattern in ("mesh_*_final.ply", os.path.join("mesh", "mesh_*.ply")):
        cands = sorted(glob.glob(os.path.join(run, pattern)))
        if cands:
            return cands[-1]
    raise FileNotFoundError(f"no recon mesh under {run}")


def voxel_components(vx: np.ndarray):
    """Connected components (6-connectivity) of the occupied voxels vx
    [N, 3] -> (component label of each of the N rows)."""
    keys, inv = np.unique(vx, axis=0, return_inverse=True)
    parent = np.arange(len(keys))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    index = {tuple(k): i for i, k in enumerate(keys)}
    for i, k in enumerate(keys):
        for ax in range(3):
            for s in (-1, 1):
                nb = list(k)
                nb[ax] += s
                j = index.get(tuple(nb))
                if j is not None:
                    ri, rj = find(i), find(j)
                    if ri != rj:
                        parent[ri] = rj
    roots = np.array([find(i) for i in range(len(keys))])
    return roots[inv.reshape(-1)]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--run", required=True,
                   help="run dir holding mesh_*_final.ply (and config.json "
                        "or gt_mesh.ply)")
    p.add_argument("--gt", default=None)
    p.add_argument("--rec", default=None)
    p.add_argument("--thresh", type=float, default=0.05,
                   help="gap threshold in meters (eval ratio uses 0.05)")
    p.add_argument("--voxel", type=float, default=0.2,
                   help="clustering voxel + planner voxel size")
    p.add_argument("--n", type=int, default=200_000)
    p.add_argument("--top", type=int, default=10)
    args = p.parse_args(argv)

    from naruto_tpu_torch.evaluation.recon import (nearest_distances,
                                                   sample_surface_points)
    from naruto_tpu_torch.mesh.ply import read_mesh, read_ply

    gt_path = ground_truth_path(args.run, args.gt)
    rec_path = recon_path(args.run, args.rec)
    gv, gf, _ = read_mesh(gt_path)
    rv, rf, _ = read_ply(rec_path)
    print(f"gt: {gt_path} ({len(gv)} v), recon: {rec_path} ({len(rv)} v)")

    rng = np.random.default_rng(0)
    gt_pts = sample_surface_points(gv, gf, args.n, rng)
    rec_pts = sample_surface_points(rv, rf, args.n, rng)
    d = nearest_distances(gt_pts, rec_pts)
    far = d > args.thresh
    gap = gt_pts[far]
    ratio = 100.0 * (1.0 - len(gap) / len(gt_pts))
    print(f"completion ratio @{args.thresh * 100:.0f}cm: {ratio:.2f}%  "
          f"({len(gap)} gap samples)")
    if not len(gap):
        return

    lo = gt_pts.min(axis=0)
    comp = voxel_components(np.floor((gap - lo) / args.voxel).astype(
        np.int64))
    comps, counts = np.unique(comp, return_counts=True)
    order = np.argsort(-counts)
    print(f"{len(comps)} gap clusters; top {min(args.top, len(comps))} "
          f"(pct = share of ALL gt samples):")
    for ci in order[:args.top]:
        sel = comp == comps[ci]
        pts = gap[sel]
        c = pts.mean(axis=0)
        vox = np.floor((c - lo) / args.voxel).astype(int)
        ext = pts.max(axis=0) - pts.min(axis=0)
        print(f"  {counts[ci]:7d} samples "
              f"({100.0 * counts[ci] / len(gt_pts):5.2f}%)"
              f"  centroid {np.round(c, 2).tolist()}"
              f"  vox {vox.tolist()}  extent {np.round(ext, 2).tolist()}"
              f"  mean_d {100 * d[far][sel].mean():.1f}cm")


if __name__ == "__main__":
    main()
