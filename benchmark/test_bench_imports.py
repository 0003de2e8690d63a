"""What a run executes loads no module whose whole top-level name is jax,
jaxlib, flax or naruto_tpu (naruto_tpu_torch begins with naruto_tpu, so
names are compared whole), and the reference loads nothing of
naruto_tpu_torch. Each cell runs in a fresh process at the tiny size on
the CPU: set-up, a short window, the reference, the comparison. And the
harness's own look for those modules comes last in a run: one loaded
after the window leaves no result."""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import types

import pytest

import checks
import run
from conftest import CELLS, HERE, ROOT

CELL_RUN = """
import json, sys, tempfile
sys.path[:0] = [{root!r}, {here!r}]
import torch
torch.set_num_threads(1)
import checks, run
from conftest import tiny_cell
with tempfile.TemporaryDirectory() as tmp:
    c = tiny_cell({cell!r}, 3, tmp)
    c.setup()
    run.window(c, 0.2, False)
    c.free()
    checks.gaps(c.obs, c.reference())
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE_RUN = """
import json, sys
sys.path.insert(0, {here!r})
import torch
torch.set_num_threads(1)
import checks, inputs, reference, scene, work
cfg = json.load(open({here!r} + "/configs/office0_parity.json"))["config"]
cfg["grid"]["hash_size"] = 10
cfg["cam"].update(H=12, W=16, fx=8.0, fy=8.0, cx=7.5, cy=5.5)
cfg["mapper"].update(sample=32, iters=1, act_ray_num_uncert_sample=8)
leaves = inputs.weights(cfg, 1, "cpu")
gens = inputs.generators(1, ("global_rays", "current_rays", "z_noise",
                             "smoothness", "keyframe_scores"), "cpu")
r = reference.Mapping(cfg, leaves, gens, "cpu", n_poses=6, kf_slots=1)
room = scene.BoxRoom(cfg["mapper"]["bound"], cfg["cam"], "cpu")
pose = torch.eye(4)
rays = r.frame_rays(*room.frame(pose.numpy()))
r.add_keyframe(rays)
r.volumes()
r.ba(r.bucket(), rays, pose, 5)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
FORBIDDEN = {"jax", "jaxlib", "flax", "naruto_tpu"}


def loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("cell", CELLS)
def test_a_cell_loads_no_jax_package(cell):
    mods = loaded(CELL_RUN.format(root=ROOT, here=HERE, cell=cell))
    assert "naruto_tpu_torch" in mods
    assert not mods & FORBIDDEN, mods & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    mods = loaded(REFERENCE_RUN.format(here=HERE))
    assert "torch" in mods
    assert not mods & (FORBIDDEN | {"naruto_tpu_torch"})


@pytest.mark.parametrize("where", [None, "reference", "comparison",
                                   "reader"])
def test_a_module_loaded_after_the_window_stops_the_result(
        tiny, where, tmp_path, monkeypatch, capsys):
    """A run on the tiny cell, the look for a card skipped: with `jax`
    planted in sys.modules by the reference, the comparison or a metric
    reader, after the window has closed, the run exits non-zero and
    prints no result; with nothing planted it prints its line."""
    assert not run.forbidden_loaded()
    cell = tiny("office0_hybrid.map", 4, str(tmp_path))

    def planted(fn):
        def inner(*a, **k):
            monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
            return fn(*a, **k)
        return inner

    if where == "reference":
        cell.reference = planted(cell.reference)
    elif where == "comparison":
        monkeypatch.setattr(checks, "gaps", planted(checks.gaps))
    elif where == "reader":
        monkeypatch.setattr(run, "reader", planted(run.reader))
    args = argparse.Namespace(workload="office0_hybrid.map", seed=4,
                              seconds=0.2, trace=0, readings=None)
    entries = run.cell_entries(run.manifest(), args.workload)
    rc = run.run_cell(args, entries, "cpu", opener=lambda *a: cell)
    out = capsys.readouterr()
    if where is None:
        assert rc == 0
        line = json.loads(out.out.strip().splitlines()[-1])
        assert {"correct", "attempted", "failed", "metrics",
                "device"} <= set(line) and line["attempted"] > 0
    else:
        assert rc != 0 and out.out.strip() == ""
        assert "jax" in out.err.strip().splitlines()[-1]
