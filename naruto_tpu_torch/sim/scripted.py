"""Scripted offline simulation: drive a simulator along a motion profile and
save its observations (counterpart of naruto_tpu/sim/scripted.py), written
by the port's image codec.

Parity with the reference's offline data-generation utilities
(src/simulator/habitat_utils.py:483-771): motion profiles (stationary /
random / spiral_forward / forward / predefined), per-frame RGB-D + pose
export in the layout ``ReplaySimulator`` reads, optional video. The video
is ``rgb.avi`` (Motion-JPEG, utils/image_io.AviWriter) where the JAX
package writes ``rgb.mp4``.

    python -m naruto_tpu_torch.sim.scripted --out DIR --traj data/traj_ab/traj.txt --n_frames 200
    python -m naruto_tpu_torch.sim.scripted --out DIR --profile spiral_forward --n_frames 100 --video
"""
from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np

from naruto_tpu_torch.geometry.pose import lookat_rotation
from naruto_tpu_torch.sim.base import to_host, truncate_color
from naruto_tpu_torch.utils.image_io import AviWriter, write_jpeg, write_png


def generate_motion_profile(profile: str, n_frames: int,
                            start_c2w: np.ndarray,
                            radius: float = 1.0,
                            seed: int = 0,
                            predefined: Optional[List[np.ndarray]] = None
                            ) -> List[np.ndarray]:
    """Returns a list of c2w poses (RDF)."""
    rng = np.random.default_rng(seed)
    start = np.asarray(start_c2w, dtype=np.float32)
    poses = []
    if profile == "stationary":
        poses = [start.copy() for _ in range(n_frames)]
    elif profile == "forward":
        for i in range(n_frames):
            p = start.copy()
            p[:3, 3] += p[:3, 2] * (0.02 * i)   # move along +z (forward, RDF)
            poses.append(p)
    elif profile == "spiral_forward":
        center = start[:3, 3]
        for i in range(n_frames):
            ang = 2 * np.pi * i / max(n_frames, 1)
            pos = center + np.array([radius * np.cos(ang),
                                     radius * np.sin(ang),
                                     0.002 * i], dtype=np.float32)
            p = start.copy()
            p[:3, :3] = lookat_rotation(pos, center) @ np.diag([1, -1, -1])
            p[:3, 3] = pos
            poses.append(p)
    elif profile == "random":
        p = start.copy()
        for _ in range(n_frames):
            p = p.copy()
            p[:3, 3] += rng.normal(scale=0.02, size=3).astype(np.float32)
            poses.append(p)
    elif profile == "predefined":
        if predefined is None:
            raise ValueError("predefined profile needs poses")
        poses = [np.asarray(q, dtype=np.float32) for q in predefined]
    else:
        raise ValueError(f"unknown motion profile: {profile}")
    return poses


def run_scripted_simulation(sim, poses: List[np.ndarray], out_dir: str,
                            save_video: bool = False,
                            depth_scale: float = 6553.5,
                            pose_format: str = "replica") -> None:
    """Render every pose and save frames/poses in the Replica-SLAM layout
    consumed by ReplaySimulator (frame%06d.jpg / depth%06d.png / traj.txt),
    plus rgb.avi with `save_video`.

    pose_format 'replica' writes traj.txt rows in the Replica convention
    (RUB — PoseLoader flips columns 1,2 back on load); 'raw' writes the RDF
    poses verbatim (MP3D convention)."""
    res = os.path.join(out_dir, "results")
    os.makedirs(res, exist_ok=True)
    video = None
    try:
        for i, c2w in enumerate(poses):
            sim.update_step(i)
            color, depth = (to_host(x) for x in sim.simulate(c2w)[:2])
            rgb = truncate_color(color)
            write_jpeg(os.path.join(res, f"frame{i:06d}.jpg"), rgb)
            d16 = np.clip(depth * depth_scale, 0, 65535).astype(np.uint16)
            write_png(os.path.join(res, f"depth{i:06d}.png"), d16)
            if save_video:
                if video is None:
                    h, w = rgb.shape[:2]
                    video = AviWriter(os.path.join(out_dir, "rgb.avi"), 20,
                                      (w, h))
                video.write(rgb)
    finally:
        if video is not None:
            video.close()
    with open(os.path.join(out_dir, "traj.txt"), "w") as f:
        for c2w in poses:
            out_pose = np.asarray(c2w, dtype=np.float64).copy()
            if pose_format == "replica":
                out_pose[:3, 1] *= -1    # RDF -> RUB columns (involution)
                out_pose[:3, 2] *= -1
            f.write(" ".join(f"{x:.8f}" for x in out_pose.reshape(-1))
                    + "\n")


def main(argv=None):
    p = argparse.ArgumentParser(
        description="render a motion profile and save it for sim.method "
                    "replay")
    p.add_argument("--out", required=True, help="output directory")
    p.add_argument("--cfg", default=None, help="YAML experiment config")
    p.add_argument("--dataset", default="Replica")
    p.add_argument("--scene", default="office0")
    p.add_argument("--profile", default="predefined",
                   choices=["stationary", "forward", "spiral_forward",
                            "random", "predefined"])
    p.add_argument("--traj", default=None,
                   help="traj.txt whose poses the predefined profile takes")
    p.add_argument("--n_frames", type=int, default=100)
    p.add_argument("--radius", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--video", action="store_true", help="also write rgb.avi")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from naruto_tpu_torch.config import load_config, make_config
    from naruto_tpu_torch.sim import init_simulator
    from naruto_tpu_torch.system.pose_loader import PoseLoader, load_traj_file

    cfg = (load_config(args.cfg) if args.cfg
           else make_config(args.dataset, args.scene))
    predefined = None
    if args.profile == "predefined":
        if not args.traj:
            raise SystemExit("--profile predefined needs --traj")
        predefined = load_traj_file(args.traj,
                                    cfg.general.dataset)[:args.n_frames]
        start = predefined[0]
    else:
        start = PoseLoader(cfg.replace(enable_active_planning=True)
                           ).load_init_pose()
    poses = generate_motion_profile(args.profile, args.n_frames, start,
                                    args.radius, args.seed, predefined)
    sim = init_simulator(cfg, args.device)
    run_scripted_simulation(sim, poses, args.out, save_video=args.video,
                            depth_scale=cfg.cam.png_depth_scale)
    print(f"wrote {len(poses)} frames to {args.out}")


if __name__ == "__main__":
    main()
