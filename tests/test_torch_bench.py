"""The port's bench entry point (naruto_tpu_torch.bench): its measure
function on the 24x32 config, its JSON line against bench.py's keys, and its
refusal to time anything but a card."""
import ast
import os

import pytest
import torch

from naruto_tpu_torch import bench
from naruto_tpu_torch.config import make_config

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"cam": {"H": 24, "W": 32, "fx": 16.0, "fy": 16.0, "cx": 15.5,
                "cy": 11.5, "far": 3.0},
        "grid": {"hash_size": 12},
        "mapper": {"sample": 64, "iters": 2, "first_iters": 8,
                   "min_pixels_cur": 8, "act_ray_num_uncert_sample": 16},
        "training": {"n_range_d": 5, "n_samples_d": 8, "smooth_pts": 8}}


def _dict_keys(fn: ast.FunctionDef, target=None):
    """Keys of the dict literal returned by fn (target None) or assigned to
    the name `target` in fn."""
    for node in ast.walk(fn):
        if target is None and isinstance(node, ast.Return) and \
                isinstance(node.value, ast.Dict):
            return [k.value for k in node.value.keys]
        if target and isinstance(node, ast.Assign) and \
                isinstance(node.value, ast.Dict) and \
                any(getattr(t, "id", None) == target for t in node.targets):
            return [k.value for k in node.value.keys if k is not None]
    raise LookupError(target)


@pytest.fixture(scope="module")
def bench_py_keys():
    """The keys of bench.py's measurement dict, its JSON line and its turbo
    row, read from its source."""
    with open(os.path.join(ROOT, "bench.py")) as f:
        tree = ast.parse(f.read())
    fns = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    turbo = next(n for n in ast.walk(fns["main"])
                 if isinstance(n, ast.Assign) and isinstance(n.value, ast.Dict)
                 and isinstance(n.targets[0], ast.Subscript))
    return {"measure": _dict_keys(fns["_measure"]),
            "result": _dict_keys(fns["main"], "result"),
            "turbo": [k.value for k in turbo.value.keys]}


@pytest.fixture(scope="module")
def measured():
    cfg = make_config("Replica", "office0", num_iter=40, overrides=TINY)
    return bench.measure(cfg, n_steps=2, windows=2, settle=1, device="cpu")


def test_measure_rows(measured, bench_py_keys):
    for name in ("parity", "turbo"):
        row = measured[name]
        assert set(bench_py_keys["measure"]) <= set(row)
        assert len(row["iters_per_sec_windows"]) == 2
        lo, hi = row["iters_per_sec_range"]
        assert 0 < lo <= hi
        assert row["bucket"] == 512
        assert row["rays_per_iter"] == 64 + 512 // 4
    # turbo: 12 uniform samples instead of 8, as configs/turbo.yaml
    assert measured["turbo"]["samples_per_ray"] == \
        measured["parity"]["samples_per_ray"] + 4
    assert measured["peak_memory_gib"] is None     # not a card


def test_json_line_has_bench_py_keys(measured, bench_py_keys):
    res = bench.bench_result(measured, "host", "host, 0 W")
    assert list(res) == bench_py_keys["result"]
    assert res["metric"] == "mapping_iters_per_sec"
    assert res["unit"] == "iters/s"
    extra = res["extra"]
    assert set(bench_py_keys["measure"]) - {"iters_per_sec"} <= set(extra)
    assert {"device", "turbo", "card", "peak_memory_gib",
            "iters_per_sec_range"} <= set(extra)
    assert set(bench_py_keys["turbo"]) <= set(extra["turbo"])
    assert res["vs_baseline"] == round(
        measured["parity"]["iters_per_sec"] / bench.BASELINE_ITERS_PER_SEC,
        3)


def test_wall_frame_matches_bench_py():
    color, depth = bench.wall_frame(4, 5)
    assert color.shape == (4, 5, 3) and depth.shape == (4, 5)
    assert (depth == 1.5).all()
    assert color[0, :, 0].tolist() == [0.0, 0.25, 0.5, 0.75, 1.0]
    assert (color[..., 1] == 0.3).all() and (color[..., 2] == 0.6).all()


def test_bench_refuses_the_host(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit) as e:
        bench.main(["--steps", "1"])
    assert e.value.code != 0
    assert capsys.readouterr().out == ""


def test_measure_one_configuration_alone():
    """With NARUTO_BENCH_CFG (bench.py's override) the row is that
    configuration's and the turbo row is not timed: here the grid of
    configs/parity.yaml (vertex layout, 16 levels of 2 features, f32)."""
    import yaml

    with open(os.path.join(ROOT, "configs", "parity.yaml")) as f:
        grid = yaml.safe_load(f)["grid"]
    cfg = make_config("Replica", "office0", num_iter=40, overrides={
        **TINY, "grid": {**grid, "hash_size": 12}})
    res = bench.measure(cfg, n_steps=1, windows=1, settle=0, device="cpu",
                        turbo=False)
    assert set(res) == {"parity", "peak_memory_gib"}
    line = bench.bench_result(res, "host", "host, 0 W")
    assert "turbo" not in line["extra"] and line["value"] > 0


def test_measure_eager_row():
    """With eager=True the parity configuration's eager BA call is a row of
    its own (Mapper._ba_impl_eager), timed in turns with the parity row."""
    cfg = make_config("Replica", "office0", num_iter=40, overrides=TINY)
    res = bench.measure(cfg, n_steps=1, windows=2, settle=0, device="cpu",
                        turbo=False, eager=True)
    assert set(res) == {"parity", "eager", "peak_memory_gib"}
    assert len(res["eager"]["iters_per_sec_windows"]) == 2
    assert res["eager"]["bucket"] == res["parity"]["bucket"]
