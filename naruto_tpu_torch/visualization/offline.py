"""Offline visualization tools over a run's saved artifacts (counterpart of
naruto_tpu/visualization/offline.py).

Role parity with the reference's offline visualizers (src/visualization/
naruto_o3d_visualizer.py, vis_traj.py, vis_mesh_evo.py,
naruto_video_maker.py — C30o in SURVEY.md), over the directory contract
of ArtifactSaver. Meshes render through the port's copy of the C++ BVH
raycaster (the JAX package's renderer, so both render a mesh alike);
plots, text, lines and resizing are visualization/raster.py's, images and
videos the port's codec's (utils/image_io.py). Videos are Motion-JPEG
``.avi`` files, where the JAX package writes mp4 through cv2.

CLI:
    python -m naruto_tpu_torch.visualization.offline traj --run <dir> --out t.png
    python -m naruto_tpu_torch.visualization.offline mesh_evo --run <dir> --out d/
    python -m naruto_tpu_torch.visualization.offline video --run <dir> --out v.avi
    python -m naruto_tpu_torch.visualization.offline replay --run <dir> --out d/ [--video r.avi]
"""
from __future__ import annotations

import argparse
import ctypes
import glob
import os
import re
from typing import List, Optional

import numpy as np

from naruto_tpu_torch.sim.base import truncate_color
from naruto_tpu_torch.utils.image_io import AviWriter, read_png, write_png
from naruto_tpu_torch.visualization import raster

WHITE = (255, 255, 255)
# the JAX package's overlay colours (given there in cv2's BGR), as RGB
TRAJ_RGB = (80, 220, 80)
PATH_RGB = (60, 200, 255)
LOOKAT_RGB = (255, 80, 255)
FRUSTUM_RGB = (255, 60, 60)


def _load_poses(run_dir: str) -> List[np.ndarray]:
    files = sorted(glob.glob(os.path.join(run_dir, "pose", "*.npy")))
    return [np.load(f) for f in files]


def plot_trajectory(run_dir: str, out_path: str) -> None:
    """Top-down + oblique trajectory plot from saved per-step poses."""
    poses = _load_poses(run_dir)
    if not poses:
        raise FileNotFoundError(f"no poses under {run_dir}/pose")
    t = np.stack([p[:3, 3] for p in poses])
    write_png(out_path, raster.trajectory_panels(t))


def _overview(bounds):
    lo, hi = bounds
    center = (lo + hi) / 2.0
    diag = float(np.linalg.norm(hi - lo))
    eye = center + np.asarray([0.9, -0.9, 0.8], np.float32) * diag * 0.75
    return _lookat_c2w(eye, center), diag


def render_mesh_still(ply_path: str, out_path: str,
                      H: int = 480, W: int = 480) -> None:
    """Render one mesh snapshot through the C++ raycaster (vertex-colored,
    hidden-surface correct, fast on 100k+ triangle meshes)."""
    r = _MeshRenderer(ply_path)
    view, _ = _overview(r.bounds)
    color, _ = r.render(view, H, W, 0.9 * W / 2.0)
    r.close()
    img = truncate_color(color)
    raster.put_text(img, os.path.basename(ply_path), (8, 20), WHITE)
    write_png(out_path, img)


def mesh_evolution(run_dir: str, out_dir: str,
                   kind: str = "color_mesh") -> List[str]:
    """Render every periodic mesh snapshot to a png (vis_mesh_evo parity)."""
    os.makedirs(out_dir, exist_ok=True)
    outs = []
    for ply in sorted(glob.glob(os.path.join(run_dir, kind, "*.ply"))):
        out = os.path.join(
            out_dir, os.path.basename(ply).replace(".ply", ".png"))
        render_mesh_still(ply, out)
        outs.append(out)
    return outs


def make_video(run_dir: str, out_path: str, fps: int = 10,
               mesh_stills_dir: Optional[str] = None) -> int:
    """Tile per-step rgbd panels (optionally side-by-side with the latest
    mesh-evolution still) into a Motion-JPEG AVI (naruto_video_maker
    parity); returns the frame count."""
    frames = sorted(glob.glob(os.path.join(run_dir, "rgbd", "*.png")))
    if not frames:
        raise FileNotFoundError(f"no rgbd frames under {run_dir}/rgbd")
    stills = (sorted(glob.glob(os.path.join(mesh_stills_dir, "*.png")))
              if mesh_stills_dir else [])
    first = read_png(frames[0])
    h, w = first.shape[:2]
    out_w = w + (h if stills else 0)
    si = 0
    with AviWriter(out_path, fps, (out_w, h)) as vw:
        for f in frames:
            img = read_png(f)
            if img.shape[:2] != (h, w):
                continue
            if stills:
                # advance to the newest mesh still at or before this frame
                while si + 1 < len(stills) and \
                        os.path.basename(stills[si + 1]) <= \
                        os.path.basename(f):
                    si += 1
                mesh_img = raster.resize_bilinear(read_png(stills[si]),
                                                  (h, h))
                img = np.concatenate([img, mesh_img], axis=1)
            vw.write(img)
        return vw.frames


# --------------------------------------------------------------- 3D replay
class _MeshRenderer:
    """Offline mesh renderer on the C++ BVH raycaster; the line overlays
    are depth-tested against its depth map."""

    def __init__(self, ply_path: str):
        from naruto_tpu_torch.mesh.ply import read_ply
        from naruto_tpu_torch.sim.raycast import _fp, _load_lib

        self._lib = _load_lib()
        self._fp = _fp
        verts, faces, colors = read_ply(ply_path)
        verts = np.ascontiguousarray(verts, dtype=np.float32)
        faces = np.ascontiguousarray(faces, dtype=np.int32)
        col_ptr = None
        if colors is not None:
            colors = np.ascontiguousarray(
                colors.astype(np.float32) / 255.0)
            col_ptr = _fp(colors)
        self._handle = self._lib.rc_create(
            _fp(verts), len(verts), col_ptr,
            faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), len(faces))
        self._keep = (verts, faces, colors)
        self.bounds = (verts.min(axis=0), verts.max(axis=0))

    def render(self, c2w: np.ndarray, H: int, W: int, f: float):
        pose = np.ascontiguousarray(c2w.astype(np.float32)).reshape(16)
        color = np.empty((H, W, 3), dtype=np.float32)
        depth = np.empty((H, W), dtype=np.float32)
        self._lib.rc_render_pinhole(
            self._handle, self._fp(pose), H, W,
            ctypes.c_float(f), ctypes.c_float(f),
            ctypes.c_float((W - 1) / 2.0), ctypes.c_float((H - 1) / 2.0),
            self._fp(color), self._fp(depth))
        return color, depth

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.rc_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


def _lookat_c2w(eye: np.ndarray, target: np.ndarray,
                up=(0.0, 0.0, 1.0)) -> np.ndarray:
    """RDF camera-to-world looking from eye at target."""
    fwd = target - eye
    fwd = fwd / max(np.linalg.norm(fwd), 1e-9)
    up = np.asarray(up, np.float32)
    right = np.cross(fwd, up)
    if np.linalg.norm(right) < 1e-6:
        right = np.cross(fwd, np.asarray([0.0, 1.0, 0.0], np.float32))
    right = right / max(np.linalg.norm(right), 1e-9)
    down = np.cross(fwd, right)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, down, fwd, eye
    return c2w


def _project(pts: np.ndarray, c2w: np.ndarray, f: float, H: int, W: int):
    """World points [N,3] -> (uv [N,2] float, z [N]) in the view camera."""
    w2c_r = c2w[:3, :3].T
    x = (pts - c2w[:3, 3]) @ w2c_r.T
    z = x[:, 2]
    zs = np.maximum(z, 1e-6)
    u = x[:, 0] / zs * f + (W - 1) / 2.0
    v = x[:, 1] / zs * f + (H - 1) / 2.0
    return np.stack([u, v], axis=-1), z


def segment_points(depth, a3, b3, c2w, f, occl_eps=0.05, n_samples=48):
    """The samples of a 3D segment in the view: per sample its pixel
    (x, y), or None where it is behind the camera, outside the image or
    occluded by the rendered depth (+ occl_eps)."""
    H, W = depth.shape
    ts = np.linspace(0.0, 1.0, n_samples)
    pts = a3[None] * (1 - ts[:, None]) + b3[None] * ts[:, None]
    uv, z = _project(pts, c2w, f, H, W)
    out = []
    for (u, v), zz in zip(uv, z):
        ok = (zz > 1e-3 and 0 <= u < W and 0 <= v < H)
        if ok:
            d = depth[int(v), int(u)]
            ok = d <= 0 or zz <= d + occl_eps
        out.append((int(u), int(v)) if ok else None)
    return out


def _draw_segment(img, depth, a3, b3, c2w, f, color, occl_eps=0.05,
                  n_samples=48):
    """Depth-tested 3D line segment drawn into img [H,W,3] uint8: a line
    between each two visible consecutive samples."""
    pts = segment_points(depth, a3, b3, c2w, f, occl_eps, n_samples)
    for prev, cur in zip(pts[:-1], pts[1:]):
        if prev is not None and cur is not None:
            raster.draw_line(img, prev, cur, color)


def _frustum_lines(c2w: np.ndarray, scale: float = 0.2,
                   aspect: float = 680.0 / 1200.0, fov_x: float = 0.785):
    """Camera frustum wireframe segments (apex + 4 image corners)."""
    hw = np.tan(fov_x) * scale
    hh = hw * aspect
    corners_cam = np.array([[-hw, -hh, scale], [hw, -hh, scale],
                            [hw, hh, scale], [-hw, hh, scale]], np.float32)
    corners = corners_cam @ c2w[:3, :3].T + c2w[:3, 3]
    apex = c2w[:3, 3]
    segs = [(apex, c) for c in corners]
    segs += [(corners[i], corners[(i + 1) % 4]) for i in range(4)]
    return segs


def _step_of(path: str) -> int:
    m = re.search(r"(\d+)", os.path.basename(path))
    return int(m.group(1)) if m else 0


def replay_segments(run_dir: str, step: int, c2w: np.ndarray, traj: list,
                    diag: float):
    """The 3D segments of one replayed step with their colours, in drawing
    order: the trajectory so far, the planning path, the look-at lines, the
    agent's frustum."""
    segs = [(np.asarray(a), np.asarray(b), TRAJ_RGB)
            for a, b in zip(traj[:-1], traj[1:])]
    pp = os.path.join(run_dir, "planning_path", f"{step:04d}.npy")
    if os.path.exists(pp):
        path = np.load(pp)
        segs += [(a.astype(np.float32), b.astype(np.float32), PATH_RGB)
                 for a, b in zip(path[:-1], path[1:])]
    lt = os.path.join(run_dir, "lookat_tgts", f"{step:04d}.npy")
    if os.path.exists(lt):
        segs += [(c2w[:3, 3], t.astype(np.float32), LOOKAT_RGB)
                 for t in np.load(lt).reshape(-1, 3)]
    segs += [(a, b, FRUSTUM_RGB)
             for a, b in _frustum_lines(c2w, scale=0.15 * diag)]
    return segs


def replay(run_dir: str, out_dir: str, H: int = 480, W: int = 640,
           stride: int = 1, video_path: Optional[str] = None) -> List[str]:
    """Replay the saved run artifacts into rendered 3D scene frames —
    parity with the reference's Open3D replay (naruto_o3d_visualizer.py:
    146-268): the latest periodic mesh + the agent's camera frustum +
    trajectory so far + planning path + look-at target lines, rendered
    from a fixed overview camera. Writes pngs (and optionally an AVI)."""
    os.makedirs(out_dir, exist_ok=True)
    poses = sorted(glob.glob(os.path.join(run_dir, "pose", "*.npy")))
    meshes = sorted(glob.glob(os.path.join(run_dir, "color_mesh", "*.ply")))
    if not poses:
        raise FileNotFoundError(f"no poses under {run_dir}/pose")
    if not meshes:
        raise FileNotFoundError(f"no meshes under {run_dir}/color_mesh")
    mesh_steps = [_step_of(m) for m in meshes]

    # overview camera from the first mesh's bounds
    renderer = _MeshRenderer(meshes[0])
    view_c2w, diag = _overview(renderer.bounds)
    f = 0.9 * W / 2.0

    traj = []
    outs = []
    cur_mesh_idx = 0
    for pose_path in poses[::stride]:
        step = _step_of(pose_path)
        c2w = np.load(pose_path).astype(np.float32)
        traj.append(c2w[:3, 3])

        want = 0
        for k, s in enumerate(mesh_steps):
            if s <= step:
                want = k
        if want != cur_mesh_idx:
            renderer.close()
            renderer = _MeshRenderer(meshes[want])
            cur_mesh_idx = want

        color, depth = renderer.render(view_c2w, H, W, f)
        img = truncate_color(color)
        for a, b, rgb in replay_segments(run_dir, step, c2w, traj, diag):
            _draw_segment(img, depth, a, b, view_c2w, f, rgb)
        state_file = os.path.join(run_dir, "state", f"{step:04d}.txt")
        if os.path.exists(state_file):
            with open(state_file) as sf:
                raster.put_text(img, sf.read().strip(), (8, 20), WHITE)

        out = os.path.join(out_dir, f"replay_{step:04d}.png")
        write_png(out, img)
        outs.append(out)
    renderer.close()

    if video_path:
        with AviWriter(video_path, 10, (W, H)) as vw:
            for o in outs:
                vw.write(read_png(o))
    return outs


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("mode", choices=["traj", "mesh_evo", "video", "replay"])
    p.add_argument("--run", required=True,
                   help="run visualization dir (containing pose/, rgbd/ ...)")
    p.add_argument("--out", required=True)
    p.add_argument("--video", default=None,
                   help="optional .avi path for replay mode")
    p.add_argument("--stride", type=int, default=1)
    p.add_argument("--kind", default="color_mesh",
                   help="mesh_evo subdir: color_mesh | uncert_mesh (saver "
                        "artifacts) or mesh (engine's periodic snapshots)")
    args = p.parse_args(argv)
    if args.mode == "traj":
        plot_trajectory(args.run, args.out)
    elif args.mode == "mesh_evo":
        mesh_evolution(args.run, args.out, kind=args.kind)
    elif args.mode == "replay":
        replay(args.run, args.out, stride=args.stride,
               video_path=args.video)
    else:
        make_video(args.run, args.out)


if __name__ == "__main__":
    main()
