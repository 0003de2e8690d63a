"""The port's evaluation tools outside the package: the protocol runner
(scripts/run_{replica,mp3d,naruto}.sh's counterpart) on two seeds at the
24x32 size, and completion_gaps on one of its runs against the JAX
package's scripts/completion_gaps.py."""
import json
import os
import runpy
import sys

import pytest
import torch
import yaml

from naruto_tpu_torch.scripts import completion_gaps, run_protocol as rp

from test_torch_engine import ACTIVE_40, ROOT

torch.set_num_threads(1)

SEEDS = (0, 500)
N_STEPS = 20


def tiny_yaml(tmp):
    """configs/Replica/office0/naruto.yaml at 24x32 for N_STEPS steps, with
    meshes at 0.1 m."""
    over = yaml.safe_load(yaml.safe_dump(json.loads(json.dumps(ACTIVE_40))))
    over["inherit_from"] = os.path.join(ROOT, "configs", "Replica",
                                        "office0", "naruto.yaml")
    over["num_iter"] = N_STEPS
    over["mesh"] = {"voxel_final": 0.1, "voxel_eval": 0.1}
    path = tmp / "tiny.yaml"
    path.write_text(yaml.safe_dump(over))
    return ["--cfg", str(path), "--device", "cpu"]


@pytest.fixture(scope="module")
def protocol(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("protocol")
    failed = rp.run_protocol("replica", "office0", len(SEEDS), "exp",
                             results_root=str(tmp), timeout=600,
                             run_args=tiny_yaml(tmp))
    return failed, tmp / "exp" / "Replica" / "office0"


def test_protocol_writes_every_row_and_the_table(protocol):
    failed, scene_dir = protocol
    assert failed == []
    for seed in SEEDS:
        rows = (scene_dir / f"seed_{seed}" / "Replica" / "office0" /
                "eval_result.txt").read_text().splitlines()
        assert rows[0].startswith("traj_length_m,") and "mad_cm" in rows[0]
    table = (scene_dir / "eval_summary.txt").read_text().splitlines()
    assert [r.split(",")[0] for r in table] == [
        "trial", *(f"seed_{s}" for s in SEEDS), "mean", "std"]
    assert table[0].split(",")[1:] == rows[0].split(",")


def test_protocol_timeout_fails_the_runner(tmp_path, monkeypatch, capsys):
    """A run that outlives --timeout is a failure, and the runner exits
    with status 1. The CLI forwards its --timeout: its arguments reach
    run_protocol, which runs the small config under a results directory of
    its own, and what it prints names the timeout."""
    failed = rp.run_protocol("replica", "office0", 1, "exp",
                             results_root=str(tmp_path), timeout=1.0,
                             run_args=tiny_yaml(tmp_path))
    assert len(failed) == 1 and "timed out after 1.0 s" in failed[0]
    real, forwarded = rp.run_protocol, []

    def small(*args, **kw):
        forwarded.append(args)
        return real(*args, results_root=str(tmp_path / "cli"),
                    run_args=tiny_yaml(tmp_path), **kw)

    monkeypatch.setattr(rp, "run_protocol", small)
    capsys.readouterr()
    with pytest.raises(SystemExit) as e:
        rp.main(["replica", "office0", "1", "cli", "--timeout", "1"])
    assert e.value.code == 1
    assert forwarded == [("replica", "office0", 1, "cli", "analytic", "",
                          1.0)]
    out = capsys.readouterr().out
    assert "1 run(s) failed:" in out
    assert "Replica/office0 seed=0: timed out after 1.0 s" in out


def test_protocol_seeds_and_scenes():
    """The shell scripts' scene lists and seeds."""
    assert rp.PROTOCOLS["replica"].scenes[0] == "office0"
    assert len(rp.PROTOCOLS["replica"].scenes) == 8
    assert [rp.trial_seed(rp.PROTOCOLS["replica"], i) for i in range(5)] \
        == [0, 500, 1000, 1500, 1999]
    assert [rp.trial_seed(rp.PROTOCOLS["naruto"], i) for i in range(3)] \
        == [0, 500, 1000]
    assert rp.PROTOCOLS["mp3d"].default_scene == "gZ6f7yhEvPG"
    with pytest.raises(ValueError):
        rp.trial_seed(rp.PROTOCOLS["mp3d"], 5)


def test_completion_gaps_matches_jax(protocol, monkeypatch, capsys):
    """The same ratio and clusters, line for line, as the JAX script on one
    run directory (both from default_rng(0))."""
    run = str(protocol[1] / f"seed_{SEEDS[0]}" / "Replica" / "office0")
    args = ["--run", run, "--n", "20000", "--top", "5"]
    completion_gaps.main(args)
    ours = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(sys, "argv", ["completion_gaps.py", *args])
    runpy.run_path(os.path.join(ROOT, "scripts", "completion_gaps.py"),
                   run_name="__main__")
    ref = capsys.readouterr().out.splitlines()
    assert ours == ref
    assert ours[1].startswith("completion ratio @5cm: ")
    assert "gap clusters" in ours[2] and len(ours) > 3


def test_completion_gaps_ground_truth_order(protocol, tmp_path):
    """--gt, else the config's scene_path mesh, else gt_mesh.ply; with none
    of them the error names every path tried."""
    run = protocol[1] / f"seed_{SEEDS[0]}" / "Replica" / "office0"
    gt = str(run / "gt_mesh.ply")
    assert completion_gaps.ground_truth_path(str(run)) == gt
    assert completion_gaps.ground_truth_path(str(tmp_path), gt) == gt
    mesh = tmp_path / "scene" / "mesh.glb"
    mesh.parent.mkdir()
    mesh.write_bytes(b"")
    (tmp_path / "config.json").write_text(json.dumps(
        {"sim": {"scene_path": str(mesh.parent)}}))
    assert completion_gaps.ground_truth_path(str(tmp_path)) == str(mesh)
    mesh.unlink()
    with pytest.raises(FileNotFoundError) as e:
        completion_gaps.ground_truth_path(str(tmp_path))
    for tried in ("mesh.ply", "mesh.glb", "gt_mesh.ply"):
        assert tried in str(e.value)
    with pytest.raises(FileNotFoundError, match="nowhere.ply"):
        completion_gaps.main(["--run", str(run), "--gt",
                              str(tmp_path / "nowhere.ply")])


def test_protocol_raycast_scene_mesh(tmp_path):
    """A raycast run's mesh: the data directory's, else one synthesised
    once per scene by make_scene_assets; a data directory without the mesh
    raises, naming it."""
    proto = rp.PROTOCOLS["naruto"]
    exp = str(tmp_path / "exp")
    args = ["--voxel", "0.25", "--device", "cpu"]
    path = rp.scene_mesh(proto, "naruto", "", exp, args)
    assert path == os.path.join(exp, "assets", "NARUTO", "naruto",
                                "mesh.glb")
    stamp = os.path.getmtime(path)
    assert rp.scene_mesh(proto, "naruto", "", exp, args) == path
    assert os.path.getmtime(path) == stamp
    data = tmp_path / "data" / "naruto"
    data.mkdir(parents=True)
    with pytest.raises(FileNotFoundError, match="mesh.ply/mesh.glb"):
        rp.scene_mesh(proto, "naruto", str(tmp_path / "data"), exp)
    (data / "mesh.glb").write_bytes(b"")
    assert rp.scene_mesh(proto, "naruto", str(tmp_path / "data"), exp) == \
        str(data / "mesh.glb")
