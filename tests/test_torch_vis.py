"""The port's artifact saver, offline visualizer, export_pose and profiling
hooks against naruto_tpu's: the rgbd panel bit for bit, the engine's
artifact contract and render skip, the offline mesh render bit for bit,
the overlays' projection and occlusion decisions, and every offline mode.
The JAX engine never runs here."""
import os
import pickle

import numpy as np
import pytest
import torch

from naruto_tpu.config import make_config as jmake_config
from naruto_tpu.visualization import offline as joffline
from naruto_tpu.visualization.saver import ArtifactSaver as JSaver
from naruto_tpu_torch import export_pose
from naruto_tpu_torch.config import make_config
from naruto_tpu_torch.config.schema import deep_update
from naruto_tpu_torch.mesh.ply import write_ply
from naruto_tpu_torch.sim.base import truncate_color
from naruto_tpu_torch.system.engine import Engine
from naruto_tpu_torch.utils import ckpt_io, image_io, profiling
from naruto_tpu_torch.visualization import offline, raster
from naruto_tpu_torch.visualization.saver import ArtifactSaver

cv2 = pytest.importorskip("cv2")

torch.set_num_threads(1)

BOUND = ((-1.5, 1.5), (-1.5, 1.5), (-1.0, 1.0))
# tests/test_sim.py::TestVisualizerArtifacts's engine, on the port
VIS_OVER = {
    "cam": {"H": 30, "W": 40, "fx": 25.0, "fy": 25.0, "cx": 19.5,
            "cy": 14.5},
    "sim": {"method": "analytic", "pinhole_hw": (30, 40),
            "erp_hw": (24, 48)},
    "mapper": {"bound": BOUND, "marching_cubes_bound": BOUND,
               "sample": 64, "iters": 2, "first_iters": 4,
               "min_pixels_cur": 4, "act_ray_num_uncert_sample": 8,
               "voxel_size": 0.25},
    "grid": {"n_levels": 4, "hash_size": 12, "voxel_sdf": 0.1},
    "training": {"n_samples_d": 8, "n_range_d": 5, "smooth_pts": 4},
    "planner": {"gs_z_levels": [3, 4, 5]},
}


def vis_cfg(tmp, vis_over, num_iter=20):
    cfg = make_config("Replica", "office0", num_iter=num_iter)
    return deep_update(cfg, {**VIS_OVER, "general": {"result_dir": str(tmp)},
                             "vis": {"enable_all_vis": True,
                                     "save_mesh_freq": 100, **vis_over}})


def frame(seed, h=30, w=40):
    rng = np.random.default_rng(seed)
    color = rng.uniform(-0.1, 1.1, (h, w, 3)).astype(np.float32)
    depth = rng.uniform(0.0, 9.0, (h, w)).astype(np.float32)
    depth[rng.uniform(size=(h, w)) < 0.2] = 0.0
    return color, depth


@pytest.mark.parametrize("case", ["mixed", "no_depth", "beyond_trunc"])
def test_rgbd_panel_matches_jax(tmp_path, case):
    """The saver's rgbd PNG is the JAX saver's bit for bit on the same
    float frame: truncation of the colour, the float64 99.5th percentile,
    jet."""
    color, depth = frame(7)
    if case == "no_depth":
        depth[:] = 0.0
    elif case == "beyond_trunc":
        depth = depth * 3.0
    mine = ArtifactSaver(make_config("Replica", "office0", overrides={
        "general": {"result_dir": str(tmp_path / "t")}}))
    theirs = JSaver(jmake_config("Replica", "office0", overrides={
        "general": {"result_dir": str(tmp_path / "j")}}))
    for s in (mine, theirs):
        s.update_step(3)
        s._save_rgbd(color, depth)
    got = image_io.read_png(mine._p("rgbd", "png"))
    want = cv2.imread(theirs._p("rgbd", "png"))[..., ::-1]
    assert got.shape == (30, 80, 3)
    np.testing.assert_array_equal(got, want)


def _count(eng, name):
    calls = []
    orig = getattr(eng.sim, name)
    setattr(eng.sim, name, lambda c2w, **kw: (calls.append(1),
                                              orig(c2w, **kw))[1])
    return calls


def test_artifact_contract(tmp_path, capsys):
    """The saver writes the reference directory contract (rgbd / pose /
    planning_path / lookat_tgts / state + manifest) on the port's active
    engine; with save_rgbd on, every frame is rendered (simulate(), whose
    float colour the panel takes); vis_rgbd says once that no window
    opens."""
    cfg = vis_cfg(tmp_path, {"save_rgbd": True, "vis_rgbd": True})
    eng = Engine(cfg, device="cpu", quiet=True)
    sims, frames = _count(eng, "simulate"), _count(eng, "frame")
    eng.run(num_iter=7)
    assert len(sims) == 7 and not frames
    root = os.path.join(str(tmp_path), "Replica", "office0",
                        "visualization")
    assert open(os.path.join(root, "README.txt")).read().startswith(
        "NARUTO-TPU")
    for sub in ("rgbd", "pose", "planning_path", "lookat_tgts", "state"):
        assert len(os.listdir(os.path.join(root, sub))) == 7, sub
    assert np.load(os.path.join(root, "pose", "0000.npy")).shape == (4, 4)
    assert image_io.read_png(os.path.join(root, "rgbd", "0006.png")).shape \
        == (30, 80, 3)
    assert open(os.path.join(root, "state", "0006.txt")).read() == \
        eng.planner.state
    assert capsys.readouterr().out.count("opens no live window") == 1


def test_skip_applies_without_rgbd_artifact(tmp_path):
    """With a saver attached but save_rgbd off, unconsumed frames still
    skip the render (poses/paths/state artifacts are frame-independent)."""
    cfg = vis_cfg(tmp_path, {"save_rgbd": False})
    eng = Engine(cfg, device="cpu", quiet=True)
    sims, frames = _count(eng, "simulate"), _count(eng, "frame")
    eng.run(num_iter=7)
    me, ke = cfg.mapper.map_every, cfg.mapper.keyframe_every
    expected = sum(1 for i in range(7)
                   if i == 0 or i % me == 0 or i % ke == 0)
    # the analytic simulator's frame() renders through simulate()
    assert len(frames) == len(sims) == expected < 7
    root = tmp_path / "Replica" / "office0" / "visualization"
    assert not os.listdir(root / "rgbd")
    assert len(os.listdir(root / "pose")) == 7


def test_saver_leaves_the_poses_alone(tmp_path):
    """The saver renders frames and reads the field: the poses of an active
    run with every artifact (meshes every 2 steps) equal a run without."""
    runs = []
    for vis in (False, True):
        cfg = vis_cfg(tmp_path / str(vis), {"save_mesh_freq": 2,
                                            "save_mesh_voxel_size": 0.2},
                      num_iter=8)
        cfg = deep_update(cfg, {"vis": {"enable_all_vis": vis}})
        eng = Engine(cfg, device="cpu", quiet=True)
        eng.run()
        runs.append(eng.mapper.poses[:8].clone())
    assert torch.equal(runs[0], runs[1])
    mesh_dir = tmp_path / "True" / "Replica" / "office0" / "visualization"
    assert sorted(os.listdir(mesh_dir / "uncert_mesh")) == [
        "0000.ply", "0002.ply", "0004.ply", "0006.ply"]


# --------------------------------------------------------------- export_pose
def test_export_pose_matches_jax(tmp_path):
    """The port's CLI gives the JAX CLI's array on the same npz checkpoint
    (the port writes it); a pickle checkpoint is refused."""
    from naruto_tpu import export_pose as jexport_pose

    poses = np.random.default_rng(0).normal(size=(7, 4, 4)).astype(
        np.float32)
    ckpt = str(tmp_path / "c.pkl")
    ckpt_io.save_tree(ckpt, {"params": {"w": np.ones(3, np.float32)},
                             "poses": poses})
    for num in (None, 3):
        extra = ["--num", str(num)] if num else []
        export_pose.main(["--ckpt", ckpt, "--out", str(tmp_path / "t.npy"),
                          *extra])
        jexport_pose.main(["--ckpt", ckpt, "--out",
                           str(tmp_path / "j.npy"), *extra])
        got, want = np.load(tmp_path / "t.npy"), np.load(tmp_path / "j.npy")
        assert got.dtype == want.dtype and got.shape == (num or 7, 4, 4)
        np.testing.assert_array_equal(got, want)
    legacy = str(tmp_path / "old.pkl")
    with open(legacy, "wb") as f:
        pickle.dump({"poses": poses}, f)
    with pytest.raises(SystemExit, match="pickle"):
        export_pose.main(["--ckpt", legacy, "--out", str(tmp_path / "x")])


# ------------------------------------------------------------------ offline
def box_run(tmp_path, n_poses=3):
    """tests/test_tools.py::test_replay_3d's artifact directory: a coloured
    box mesh at step 0, poses, planning paths, look-at targets, states,
    and rgbd panels."""
    run_dir = tmp_path / "visualization"
    for sub in ("pose", "color_mesh", "planning_path", "lookat_tgts",
                "state", "rgbd"):
        (run_dir / sub).mkdir(parents=True)
    lo, hi = np.array([-1.0, -1, -1]), np.array([1.0, 1, 1])
    corners = np.array([[x, y, z] for x in (lo[0], hi[0])
                        for y in (lo[1], hi[1])
                        for z in (lo[2], hi[2])], np.float32)
    quads = [(0, 1, 3, 2), (4, 5, 7, 6), (0, 1, 5, 4), (2, 3, 7, 6),
             (0, 2, 6, 4), (1, 3, 7, 5)]
    faces = []
    for a, b, c, d in quads:
        faces += [[a, b, c], [a, c, d]]
    write_ply(str(run_dir / "color_mesh" / "0000.ply"), corners,
              np.asarray(faces, np.int32), (corners - lo) / 2.0)
    for i in range(n_poses):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = [i * 0.1, 0, 0]
        np.save(run_dir / "pose" / f"{i:04d}.npy", T)
        np.save(run_dir / "planning_path" / f"{i:04d}.npy",
                np.asarray([[0, 0, 0], [0.5, 0, 0], [0.5, 0.8, 1.2]],
                           np.float32))
        np.save(run_dir / "lookat_tgts" / f"{i:04d}.npy",
                np.asarray([[0.9, 0.9, 0.0], [-2.0, 0.5, 0.3]],
                           np.float32))
        with open(run_dir / "state" / f"{i:04d}.txt", "w") as f:
            f.write("movingToGoal")
        image_io.write_png(str(run_dir / "rgbd" / f"{i:04d}.png"),
                           np.full((20, 40, 3), i * 40, np.uint8))
    return run_dir


def test_mesh_render_matches_jax(tmp_path):
    """Both packages' mesh renderers (the same C++ raycaster, each its own
    build) give the same colour and depth, and the same overview camera."""
    ply = str(box_run(tmp_path) / "color_mesh" / "0000.ply")
    mine, theirs = offline._MeshRenderer(ply), joffline._MeshRenderer(ply)
    view, diag = offline._overview(mine.bounds)
    lo, hi = theirs.bounds
    center = (lo + hi) / 2.0
    eye = center + np.asarray([0.9, -0.9, 0.8], np.float32) \
        * float(np.linalg.norm(hi - lo)) * 0.75
    np.testing.assert_array_equal(view, joffline._lookat_c2w(eye, center))
    for r in (mine, theirs):
        r.out = r.render(view, 90, 120, 0.9 * 120 / 2.0)
        r.close()
    np.testing.assert_array_equal(mine.out[0], theirs.out[0])
    np.testing.assert_array_equal(mine.out[1], theirs.out[1])
    assert (mine.out[1] > 0).any()


def test_overlay_decisions_match_jax(tmp_path, monkeypatch):
    """Every line the replay draws (the visible pairs of projected, depth-
    tested segment samples) is the JAX replay's cv2.line call, in order,
    with the same colour (BGR there)."""
    run_dir = str(box_run(tmp_path))
    mine, theirs = [], []
    draw = raster.draw_line
    monkeypatch.setattr(raster, "draw_line", lambda img, a, b, c, *k: (
        mine.append((tuple(a), tuple(b), tuple(c))), draw(img, a, b, c))[1])
    monkeypatch.setattr(cv2, "line", lambda img, a, b, c, *k: theirs.append(
        (tuple(a), tuple(b), tuple(c[::-1]))))
    offline.replay(run_dir, str(tmp_path / "t"), H=90, W=120)
    joffline.replay(run_dir, str(tmp_path / "j"), H=90, W=120)
    assert len(mine) > 20
    assert mine == theirs


def _dilate(mask, r):
    out = mask.copy()
    h, w = mask.shape
    p = np.pad(mask, r)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            out |= p[r + dy:r + dy + h, r + dx:r + dx + w]
    return out


def test_replay_pixels_within_the_overlays(tmp_path):
    """Where the port's replay frame and the JAX one differ, the pixel lies
    within 2 pixels of one the JAX overlays drew (anti-aliased lines and
    Hershey text there, plain lines and a bitmap font here)."""
    run_dir = str(box_run(tmp_path))
    mine = offline.replay(run_dir, str(tmp_path / "t"), H=90, W=120)
    theirs = joffline.replay(run_dir, str(tmp_path / "j"), H=90, W=120)
    r = offline._MeshRenderer(os.path.join(run_dir, "color_mesh",
                                           "0000.ply"))
    view, _ = offline._overview(r.bounds)
    bare = truncate_color(r.render(view, 90, 120, 0.9 * 120 / 2.0)[0])
    r.close()
    for m, j in zip(mine, theirs):
        got = image_io.read_png(m)
        want = cv2.imread(j)[..., ::-1]
        overlay = (want != bare).any(-1)
        differ = (got != want).any(-1)
        assert overlay.sum() > 100 and (got != bare).any(-1).sum() > 100
        assert not (differ & ~_dilate(overlay, 2)).any()


def test_mesh_still_matches_jax_outside_the_label(tmp_path):
    ply = str(box_run(tmp_path) / "color_mesh" / "0000.ply")
    offline.render_mesh_still(ply, str(tmp_path / "t.png"))
    joffline.render_mesh_still(ply, str(tmp_path / "j.png"))
    got = image_io.read_png(str(tmp_path / "t.png"))
    want = cv2.imread(str(tmp_path / "j.png"))[..., ::-1]
    assert got.shape == want.shape == (480, 480, 3)
    np.testing.assert_array_equal(got[24:], want[24:])
    assert (got[:24] == 255).all(-1).any()


def test_offline_modes(tmp_path):
    """Every mode of the CLI on a saved artifact directory: the trajectory
    plot, mesh stills, the rgbd video (with the stills beside it through
    make_video) and the replay with its video; an mp4 path is refused."""
    run_dir = str(box_run(tmp_path, n_poses=4))
    out = tmp_path / "out"
    offline.main(["traj", "--run", run_dir, "--out", str(out) + "_t.png"])
    assert image_io.read_png(str(out) + "_t.png").shape == (600, 1200, 3)
    offline.main(["mesh_evo", "--run", run_dir, "--out", str(out / "evo")])
    assert os.listdir(out / "evo") == ["0000.png"]
    offline.main(["video", "--run", run_dir, "--out", str(out) + "_v.avi"])
    frames = image_io.read_avi_frames(str(out) + "_v.avi")
    assert len(frames) == 4 and frames[0].shape == (20, 40, 3)
    n = offline.make_video(run_dir, str(out) + "_s.avi",
                           mesh_stills_dir=str(out / "evo"))
    assert n == 4
    assert image_io.read_avi_frames(str(out) + "_s.avi")[0].shape == \
        (20, 60, 3)
    offline.main(["replay", "--run", run_dir, "--out", str(out / "rep"),
                  "--stride", "2", "--video", str(out) + "_r.avi"])
    assert sorted(os.listdir(out / "rep")) == ["replay_0000.png",
                                               "replay_0002.png"]
    assert len(image_io.read_avi_frames(str(out) + "_r.avi")) == 2
    with pytest.raises(ValueError, match=r"\.avi"):
        offline.make_video(run_dir, str(out) + "_v.mp4")


# ---------------------------------------------------------------- profiling
def test_device_trace_and_time_call(tmp_path):
    """device_trace writes a Chrome trace of the block on the CPU (the
    card's kernels too where CUDA is), with the program's spans in it as
    user annotations around the operators they enclose."""
    import json

    from naruto_tpu_torch.utils.timer import span

    x = torch.randn(64, 64)
    with profiling.device_trace(str(tmp_path)):
        with span("vis.mm"):
            (x @ x).sum()
    trace = (tmp_path / "trace.json").read_text()
    assert "traceEvents" in trace and "aten::mm" in trace
    events = json.loads(trace)["traceEvents"]
    (s,) = [e for e in events if e.get("name") == "vis.mm"]
    (mm,) = [e for e in events if e.get("name") == "aten::mm"]
    assert s["cat"] == "user_annotation"
    assert s["ts"] <= mm["ts"] and mm["ts"] + mm["dur"] <= s["ts"] + s["dur"]
