"""Scene meshes for the raycast simulator, synthesised from an analytic
scene (the port's counterpart of scripts/make_scene_assets.py, without
jax).

Marching cubes over the scene's analytic SDF (AnalyticSimulator.
gt_occupancy_volume, on --device) at a voxel size (default the scene's
mesh.voxel_eval), vertex-coloured by the analytic albedo, written as a
.ply or a .glb for ``run --sim raycast --scene_path <mesh>``:

    python -m naruto_tpu_torch.scripts.make_scene_assets \\
        --dataset Replica --scene office0 --out /tmp/office0.ply
    python -m naruto_tpu_torch.scripts.make_scene_assets \\
        --dataset NARUTO --scene hokage_room --format glb \\
        --out /tmp/hokage_room.glb

Without --out the mesh goes to data/<dataset>/<scene>/mesh.<format>, where
the JAX package's script writes it.
"""
from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch


def make_scene_mesh(dataset: str, scene: str, voxel: Optional[float] = None,
                    device="cuda"):
    """(verts [N, 3] f32 world, faces [M, 3], colours [N, 3] uint8) of the
    analytic scene's surface at `voxel` (default mesh.voxel_eval)."""
    from naruto_tpu_torch.config import make_config
    from naruto_tpu_torch.mesh.marching import marching_cubes
    from naruto_tpu_torch.sim.analytic import AnalyticSimulator

    cfg = make_config(dataset, scene)
    sim = AnalyticSimulator(cfg, device)
    vs = voxel or cfg.mesh.voxel_eval
    v_vox, faces = marching_cubes(sim.gt_occupancy_volume(vs),
                                  truncation=1e9)
    verts = v_vox * vs + cfg.mapper.bound_np[:, 0]
    with torch.no_grad():
        albedo = sim.color_fn(torch.from_numpy(
            np.asarray(verts, np.float32)).to(sim.device)).cpu().numpy()
    colors = (np.clip(albedo, 0.0, 1.0) * 255).astype(np.uint8)
    return verts, faces, colors


def write_scene_mesh(path: str, verts, faces, colors) -> None:
    """A .glb (colours as f32 in [0, 1]) or a .ply (uint8 colours)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if path.lower().endswith(".glb"):
        from naruto_tpu_torch.mesh.gltf import write_glb

        write_glb(path, verts, faces,
                  colors=colors.astype(np.float32) / 255.0)
    else:
        from naruto_tpu_torch.mesh.ply import write_ply

        write_ply(path, verts, faces, colors=colors)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dataset", default="Replica")
    p.add_argument("--scene", default="office0")
    p.add_argument("--voxel", type=float, default=None,
                   help="marching-cubes voxel (default: cfg.mesh.voxel_eval)")
    p.add_argument("--format", choices=("ply", "glb"), default="ply")
    p.add_argument("--out", default=None,
                   help="output mesh path (default data/<dataset>/<scene>/"
                        "mesh.<format>)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the SDF volume (default cuda; cpu "
                        "runs on the host)")
    args = p.parse_args(argv)
    out = args.out or os.path.join("data", args.dataset, args.scene,
                                   f"mesh.{args.format}")
    if not out.lower().endswith(f".{args.format}"):
        p.error(f"--out {out} is not a .{args.format} file (--format)")
    verts, faces, colors = make_scene_mesh(args.dataset, args.scene,
                                           args.voxel, args.device)
    write_scene_mesh(out, verts, faces, colors)
    print(f"wrote {out}: {len(verts)} verts, {len(faces)} faces", flush=True)


if __name__ == "__main__":
    main()
