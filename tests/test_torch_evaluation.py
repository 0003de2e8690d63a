"""The port's own copies of the numpy modules (evaluation, results file,
trajectory loader, timer) against naruto_tpu's on identical arrays."""
import os

import numpy as np
import pytest
import torch

from naruto_tpu import evaluation as jeval
from naruto_tpu.evaluation.recon import icp_align as jicp
from naruto_tpu.mesh.marching import marching_cubes
from naruto_tpu.system import pose_loader as jpose
from naruto_tpu.utils import results as jresults
from naruto_tpu.utils.timer import Timer as JTimer
from naruto_tpu_torch import evaluation as teval
from naruto_tpu_torch.evaluation.recon import icp_align as ticp
from naruto_tpu_torch.system import pose_loader as tpose
from naruto_tpu_torch.utils import results as tresults
from naruto_tpu_torch.utils.timer import Timer as TTimer

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAJ = os.path.join(ROOT, "data", "traj_ab", "traj.txt")


def sphere_mesh(n=32, r=10.0, shift=(0.0, 0.0, 0.0)):
    g = np.arange(n, dtype=np.float32)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    c = (n - 1) / 2.0
    v, f = marching_cubes(
        np.sqrt((x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2) - r,
        truncation=1e9)
    return (v - c) / r + np.asarray(shift, np.float32), f


@pytest.mark.parametrize("shift,align", [((0.0, 0.0, 0.0), False),
                                         ((0.1, 0.0, 0.0), False),
                                         ((0.03, -0.02, 0.01), True)])
def test_eval_mesh_matches_jax(shift, align):
    rv, rf = sphere_mesh(shift=shift)
    gv, gf = sphere_mesh(28, 9.0)
    got = teval.eval_mesh(rv, rf, gv, gf, n_samples=5000, align=align)
    want = jeval.eval_mesh(rv, rf, gv, gf, n_samples=5000, align=align)
    assert got == want


def test_surface_sampling_and_icp_match_jax():
    v, f = sphere_mesh()
    for seed in (0, 3):
        np.testing.assert_array_equal(
            teval.sample_surface_points(v, f, 3000, seed),
            jeval.sample_surface_points(v, f, 3000, seed))
    pts = teval.sample_surface_points(v, f, 2000)
    pts = pts[pts[:, 0] > 0]
    shifted = pts + np.array([0.05, -0.03, 0.02])
    np.testing.assert_array_equal(ticp(shifted, pts), jicp(shifted, pts))
    np.testing.assert_array_equal(teval.nearest_distances(shifted, pts),
                                  jeval.nearest_distances(shifted, pts))


@pytest.mark.parametrize("occlusion", [False, True])
def test_cull_mesh_matches_jax(occlusion):
    v, f = sphere_mesh()
    pose = np.eye(4)
    pose[:3, 3] = [0, 0, -3.0]
    pose2 = pose.copy()
    pose2[:3, 3] = [0.5, 0.2, -3.0]
    # occlusion: a wide view whose far hemisphere lies behind the observed
    # depth; frustum: a narrow view of the central cap
    fx = 50.0 if occlusion else 200.0
    K = np.array([[fx, 0, 31.5], [0, fx, 31.5], [0, 0, 1]])
    depth = np.full((64, 64), 2.1, dtype=np.float32)
    fn = (lambda i: depth) if occlusion else None
    got = teval.cull_mesh(v, f, [pose, pose2], K, (64, 64), depth_fn=fn)
    want = jeval.cull_mesh(v, f, [pose, pose2], K, (64, 64), depth_fn=fn)
    assert 0 < len(got[0]) < len(v)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dataset", ["Replica", "MP3D"])
def test_load_traj_file_matches_jax(dataset):
    got = tpose.load_traj_file(TRAJ, dataset)
    want = jpose.load_traj_file(TRAJ, dataset)
    assert len(got) == len(want) == 1000
    np.testing.assert_array_equal(np.stack(got), np.stack(want))


@pytest.mark.parametrize("n", [2, 40, 1000])
def test_eval_traj_length_matches_jax(n):
    poses = np.stack(jpose.load_traj_file(TRAJ, "Replica"))[:n]
    assert teval.eval_traj_length(poses) == jeval.eval_traj_length(poses)


def test_update_results_file_matches_jax(tmp_path):
    rows = [{"traj_length_m": 33.179382}, {"accuracy_cm": 1.3,
                                            "mad_cm": 0.47},
            {"traj_length_m": 2.0}]
    for pkg, name in ((tresults, "t.txt"), (jresults, "j.txt")):
        for r in rows:
            pkg.update_results_file(r, str(tmp_path / name))
    assert (tmp_path / "t.txt").read_text() == \
        (tmp_path / "j.txt").read_text()


def test_merge_seed_results_matches_jax(tmp_path):
    for root, pkg in ((tmp_path / "t", tresults), (tmp_path / "j", jresults)):
        for seed, acc in ((0, 1.0), (500, 2.0), (1999, 3.0)):
            d = root / f"seed_{seed}" / "Replica" / "office0"
            d.mkdir(parents=True)
            pkg.update_results_file({"accuracy_cm": acc, "mad_cm": acc / 2},
                                    str(d / "eval_result.txt"))
        pkg.merge_seed_results(str(root))
    names = sorted(p.name for p in (tmp_path / "t").iterdir()
                   if p.is_file())
    assert names and names == sorted(p.name for p in (tmp_path / "j")
                                     .iterdir() if p.is_file())
    for n in names:
        assert (tmp_path / "t" / n).read_text() == \
            (tmp_path / "j" / n).read_text()


def test_timer_matches_jax():
    """The same recorded sections give the same summary; the context manager
    records one timing per use under its group."""
    summaries = []
    for cls in (TTimer, JTimer):
        t = cls()
        with t.time("a", "G"):
            pass
        with t.time("a", "G"):
            pass
        t.start("b")
        t.end("b")
        assert len(t.timings["a"]) == 2 and t.groups["b"] == "General"
        assert sum(t.timings["a"]) >= 0 and t.get_last_timing("b") >= 0
        t.timings = {"SLAM": [0.5, 0.25, 1.0], "Simulation": [0.125],
                     "ba_dispatch": [0.01, 0.02]}
        t.groups = {"SLAM": "General", "Simulation": "General",
                    "ba_dispatch": "Mapper"}
        summaries.append(t.summary())
    assert summaries[0] == summaries[1]
    assert "[Mapper]" in summaries[0]


@pytest.mark.parametrize("num_iter", [300, 3000])
def test_evaluate_cli_reads_a_cut_runs_checkpoint(num_iter, tmp_path):
    """evaluate --ckpt on the checkpoint of a run whose general.num_iter is
    not the preset's (`run --num_iter N`), its pose table shorter (300) or
    longer (3000) than the preset's: the trajectory of the checkpoint's
    poses up to its step and the MAD of its field."""
    from naruto_tpu.mesh.ply import write_ply
    from naruto_tpu_torch import evaluate as tcli
    from naruto_tpu_torch.config import make_config
    from naruto_tpu_torch.mapping.mapper import Mapper

    src = Mapper(make_config("Replica", "office0", num_iter=num_iter),
                 device="cpu")
    preset = Mapper(make_config("Replica", "office0"), device="cpu")
    assert len(src.poses) != len(preset.poses)
    for i in range(1, 6):
        src.poses[i, :3, 3] = torch.tensor([0.1 * i, 0.02 * i, 0.0])
    with torch.no_grad():
        src.params["sdf_mlp"][0].add_(0.25)
    src.step = 5
    ckpt = str(tmp_path / "ckpt.pkl")
    src.save_ckpt(ckpt)
    v, f = sphere_mesh()
    rec, gt = str(tmp_path / "rec.ply"), str(tmp_path / "gt.ply")
    write_ply(rec, v, f)
    write_ply(gt, v, f)
    out = tmp_path / "t.txt"
    tcli.main(["--rec", rec, "--gt", gt, "--ckpt", ckpt, "--n_samples",
               "2000", "--out", str(out), "--device", "cpu"])
    row = dict(zip(*[ln.split(",") for ln in
                     out.read_text().strip().splitlines()[-2:]]))
    want_traj = teval.eval_traj_length(src.poses[:6].numpy())
    want_mad = teval.eval_mad(src, v, f, n_samples=2000)
    assert want_traj > 0.5
    np.testing.assert_allclose(float(row["traj_length_m"]), want_traj,
                               rtol=1e-5)
    np.testing.assert_allclose(float(row["mad_cm"]), want_mad, rtol=1e-5)
    assert float(row["mad_cm"]) != pytest.approx(
        teval.eval_mad(preset, v, f, n_samples=2000), rel=1e-3)


def test_evaluate_cli(tmp_path):
    """The port's evaluate CLI on the host (--device cpu): the JAX CLI's row
    for the same meshes and no checkpoint."""
    from naruto_tpu import evaluate as jcli
    from naruto_tpu.mesh.ply import write_ply
    from naruto_tpu_torch import evaluate as tcli

    v, f = sphere_mesh()
    gv, gf = sphere_mesh(28, 9.0)
    rec, gt = str(tmp_path / "rec.ply"), str(tmp_path / "gt.ply")
    write_ply(rec, v, f)
    write_ply(gt, gv, gf)
    args = ["--rec", rec, "--gt", gt, "--n_samples", "5000"]
    tcli.main(args + ["--out", str(tmp_path / "t.txt"), "--device", "cpu"])
    jcli.main(args + ["--out", str(tmp_path / "j.txt"), "--platform", "cpu"])
    assert (tmp_path / "t.txt").read_text() == \
        (tmp_path / "j.txt").read_text()
    # a .glb ground truth, ported: the JAX CLI's row for it
    from naruto_tpu.mesh.gltf import write_glb

    glb = str(tmp_path / "gt.glb")
    write_glb(glb, gv, gf)
    args = ["--rec", rec, "--gt", glb, "--n_samples", "5000"]
    tcli.main(args + ["--out", str(tmp_path / "tg.txt"), "--device", "cpu"])
    jcli.main(args + ["--out", str(tmp_path / "jg.txt"), "--platform",
                      "cpu"])
    assert (tmp_path / "tg.txt").read_text() == \
        (tmp_path / "jg.txt").read_text()
    assert (tmp_path / "tg.txt").read_text() == \
        (tmp_path / "t.txt").read_text()

