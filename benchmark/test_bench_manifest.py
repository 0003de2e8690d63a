"""BENCHMARK.json against the benchmark's contract, and the harness finding
a cell's configuration, traffic and metrics by name alone."""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil

import pytest

import cells
import run
from conftest import TINY

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
METRIC_KEYS = {"name", "unit", "better", "source", "workloads"}


def bench():
    return run.manifest()


def test_top_level_keys_and_command():
    b = bench()
    assert set(b) == KEYS
    assert b["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= len(b["paths"]) <= 16
    for p in b["paths"]:
        assert PATH.match(p) and ".." not in p and not p.startswith("/")
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert len(json.dumps(b)) <= 64 * 1024


def test_names_and_units_use_allowed_characters():
    b = bench()
    names = [c["name"] for c in b["configs"]] + \
        [w["name"] for w in b["workloads"]] + \
        [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in b["workloads"]]:
        assert NAME.match(n), n
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for text in ([c["why"] for c in b["configs"] + b["workloads"]]
                 + [m["layer"] for m in b["per_layer"]]
                 + [c["source"] for c in b["configs"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_configs_cells_and_bounds():
    b = bench()
    used = {w["config"] for w in b["workloads"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"].startswith("benchmark/")
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert len(c["reduced"]) <= 16
        f = run.load_json(os.path.join(ROOT, c["file"]))
        assert f["reduced"] == c["reduced"]
        # a changed group is named by its top-level key, each departure
        # beside its published value
        assert all(k in f["config"] for k in c["reduced"])
        assert sorted({k.split(".")[0] for k in f.get("departs", {})}) \
            == sorted(c["reduced"])
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        assert os.path.isfile(os.path.join(HERE, "traffic",
                                           w["traffic"] + ".json"))
        assert os.path.isfile(os.path.join(HERE, "limits",
                                           w["name"] + ".json"))
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) <= METRIC_KEYS | {"bound"} and "bound" in m
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_every_metric_has_a_reader_and_per_layer_metrics_move_one():
    b = bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    cells = [w["name"] for w in b["workloads"]]
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(run.reader(m["name"]))
    for m in b["per_layer"]:
        assert set(m) == METRIC_KEYS | {"layer", "moves"}
        target = e2e[m["moves"]]
        for w in m["workloads"]:
            assert w in cells and w in target.get("workloads", cells)
    for w in cells:
        got = run.cell_entries(b, w)
        assert any(m["name"] == "setup_s" for m in got["end_to_end"])
        assert len(got["end_to_end"]) >= 2 and got["per_layer"]


def test_a_new_cell_config_traffic_and_metric_are_found_from_files(tmp_path):
    """A later change adds files and entries only: a configuration, a
    kind of traffic, a traffic mix, a per-layer metric and a cell over
    them, in a copy of the benchmark, are found by name without editing a
    file that is there. A run of a kind whose unit completes BA iterations
    reports map_iters_per_s; a run of a kind with other units does not."""
    root = tmp_path / "checkout"
    shutil.copytree(HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    (root / "data" / "traj_ab").mkdir(parents=True)
    shutil.copy(os.path.join(ROOT, "data", "traj_ab", "traj.txt"),
                root / "data" / "traj_ab")
    b = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "benchmark/configs/office0_hybrid.json")
                     .read_text())
    cfg["name"] = "office1_hybrid"
    cfg["config"] = cells.merged(cfg["config"], TINY)   # runs on the CPU
    cfg["config"]["general"]["scene"] = "office1"
    (root / "benchmark/configs/office1_hybrid.json").write_text(
        json.dumps(cfg))
    traffic = json.loads((root / "benchmark/traffic/map.json").read_text())
    traffic["current"] = 300
    traffic["keyframes"]["count"] = 60
    traffic["checked_calls"] = 1
    kinds = {"map_calls": "iters", "map_rounds": "calls"}
    for kind, units in kinds.items():
        (root / f"benchmark/kinds/{kind}.py").write_text(
            "import os\nimport cells\n"
            "ROOT = os.path.dirname(os.path.dirname(os.path.dirname("
            "os.path.abspath(__file__))))\n\n\n"
            f"class Cell(cells.kind('map', ROOT)):\n    units = {units!r}\n")
        (root / f"benchmark/traffic/{kind}.json").write_text(
            json.dumps(dict(traffic, kind=kind)))
        (root / f"benchmark/limits/office1_hybrid.{kind}.json").write_text(
            json.dumps({"loss_gap": 1.0}))
        b["workloads"].append({"name": f"office1_hybrid.{kind}",
                               "config": "office1_hybrid", "traffic": kind,
                               "chips": 1, "why": "x"})
    (root / "benchmark/metrics/calls.map.py").write_text(
        "def read(run):\n    return float(len(run.unit_s))\n")
    b["configs"].append({"name": "office1_hybrid", "source": "x",
                         "file": "benchmark/configs/office1_hybrid.json",
                         "reduced": [], "why": "x"})
    b["per_layer"].append({"name": "calls.map", "unit": "calls",
                           "better": "higher", "source": "host_clock",
                           "layer": "BA dispatch", "moves": "map_iters_per_s",
                           "workloads": [f"office1_hybrid.{k}"
                                         for k in kinds]})
    for m in b["end_to_end"]:
        if m["name"] == "map_iters_per_s":
            m["workloads"] += [f"office1_hybrid.{k}" for k in kinds]
    (root / "BENCHMARK.json").write_text(json.dumps(b))

    for kind, units in kinds.items():
        cell_name = f"office1_hybrid.{kind}"
        entries = run.cell_entries(run.manifest(str(root)), cell_name)
        assert [m["name"] for m in entries["per_layer"]] == ["calls.map"]
        assert "map_iters_per_s" in [m["name"]
                                     for m in entries["end_to_end"]]
        cell = run.open_cell(entries, 5, "cpu", str(tmp_path),
                             root=str(root))
        assert cell.cfg["general"]["scene"] == "office1"
        assert cell.traffic["current"] == 300
        assert len(cell.keyframe_ids()) == 60
        assert cell.units == units
        reader = run.reader("calls.map", root=str(root))
        assert reader(type("R", (), {"unit_s": [0.1, 0.2]})) == 2.0
        args = argparse.Namespace(seconds=0.2, trace=0)
        out = run.measure(args, entries, cell, str(tmp_path), root=str(root))
        assert out["correct"] and out["attempted"] > 0
        got = out["metrics"]
        if units == "iters":
            assert got["map_iters_per_s"]["value"] > 0
            assert got["map_iters_per_s"]["unit"] == "iters/s"
        else:
            assert "map_iters_per_s" not in got
        assert "setup_s" in got


@pytest.mark.parametrize("name", ["map_iters_per_s", "peak_mem_gib",
                                  "setup_s"])
def test_end_to_end_metrics_present(name):
    assert name in {m["name"] for m in bench()["end_to_end"]}
