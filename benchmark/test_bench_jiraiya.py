"""The ``jiraiya_parity`` configuration and its ``mapstep`` cell on the CPU:
the configuration is the port's jiraiya on Co-SLAM's grid and sizes the
volumes and the uncertainty grid at 306^3; a tiny mapping-step cell at the
configuration's 0.02 m voxels, its volume query in several chunks, agrees
with the plain reference, and volumes a step late do not; the work of a
volume query; and the cell's four readers, which read nothing in a
``map`` run."""
from __future__ import annotations

import dataclasses
import os
from types import SimpleNamespace

import numpy as np
import pytest
import yaml

import checks
import program_spans
import reference
import run
import scene
import volume_work
import work
from conftest import HERE, ROOT
from naruto_tpu_torch.config import load_config
from naruto_tpu_torch.config.schema import deep_update
from naruto_tpu_torch.mapping import field
from naruto_tpu_torch.utils import timer

CELL = "jiraiya_parity.mapstep"
SIDE = 306
READERS = ("volume_query_ms.mapstep", "volume_host_ms.mapstep",
           "mapstep_mfu", "idle_share.mapstep")
# a 0.8 m cube around the first poses of the path (0.2, -0.65, 0.3): at
# the configuration's 0.02 m, 41^3 = 68,921 voxels, queried in 5 chunks
# of 12,000 and a last one of 8,921
SMALL = [[-0.2, 0.6], [-1.05, -0.25], [-0.1, 0.7]]
CHUNK = 12_000
# the tiny cell's agreement, on Co-SLAM's float32 grid: seeds 7-8 read
# loss, moment and change gaps under 3e-5, the SDF 7.6e-4 of its norm,
# 8.7e-5 of the voxels across the band edge and an uncertainty gap of
# 3.8e-5 (the set-up volume bit for bit): each tolerance over 10x those
TINY_AGREE = {"first_loss_gap": 1e-6, "loss_gap": 1e-3, "moment_gap": 1e-3,
              "change_gap": 1e-3, "volume_sdf_gap": 0.01,
              "volume_band_gap": 0.01, "volume_uncert_gap": 0.01,
              "volume_first_gap": 1e-6}
# volumes a step late (seeds 7-8): the SDF 0.90-1.05 of its norm off, a
# third to a half of the voxels across the band edge
STALE_SDF, STALE_BAND = 0.3, 0.1


def config():
    return run.load_json(os.path.join(HERE, "configs",
                                      "jiraiya_parity.json"))


def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def test_the_configuration_is_the_ports_jiraiya_on_coslams_grid():
    """configs/NARUTO/jiraiya/naruto.yaml as the port loads it, with
    configs/parity.yaml's grid: no key departs, nothing is cut."""
    with open(os.path.join(ROOT, "configs", "parity.yaml")) as f:
        grid = yaml.safe_load(f)["grid"]
    port = deep_update(load_config(os.path.join(
        ROOT, "configs", "NARUTO", "jiraiya", "naruto.yaml")),
        {"grid": grid})
    f = config()
    assert f["config"] == _plain(dataclasses.asdict(port))
    assert f["reduced"] == [] and "departs" not in f
    assert (grid["layout"], grid["n_levels"], grid["n_features_per_level"],
            grid["table_dtype"]) == ("vertex", 16, 2, "float32")


def test_volumes_and_uncertainty_grid_are_306_cubed():
    cfg = config()["config"]
    m = cfg["mapper"]
    assert m["voxel_size"] == cfg["planner"]["voxel_size"] == 0.02
    assert reference.volume_shape(m["bound"], m["voxel_size"]) == (SIDE,) * 3
    assert reference.param_shapes(cfg)["uncert"] == [(SIDE,) * 3]
    assert volume_work.voxels(cfg) == SIDE ** 3 == 28_652_616
    # the query runs in chunks at this size; office0's 96,040 voxels take
    # one, so the office0 cells' volumes are the one-batch query's
    assert SIDE ** 3 > field.VOLUME_CHUNK >= 96_040


def test_volume_query_work():
    """Per voxel: the SDF MLP's 80 x 32 + 32 x 16 multiply-adds, 16 levels
    of the trilinear blend of 2 features and the uncertainty grid's; 20
    bytes, and the table and the uncertainty grid once each."""
    cfg = config()["config"]
    flops, nbytes = volume_work.volume_query_work(cfg)
    n = SIDE ** 3
    assert flops == n * (2 * (80 * 32 + 32 * 16) + 16 * (16 + 32) + 32)
    table = reference.Grid(cfg).total * 2
    assert nbytes == n * 20 + table * 4 + n * 4
    least, by = work.least_seconds(flops, nbytes)
    assert by == "flops" and 2e-3 < least < 4e-3


def _tiny(tiny, tmp, fault=None, seed=7):
    return tiny(CELL, seed, str(tmp), fault=fault, traffic={
        "config": {"mapper": {"bound": SMALL,
                              "marching_cubes_bound": SMALL}}})


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """The tiny cell's set-up (its queries in chunks of CHUNK), a short
    window and the reference; the volume counts of the set-up."""
    from conftest import tiny_cell

    tmp = tmp_path_factory.mktemp("jiraiya")
    mp = pytest.MonkeyPatch()
    mp.setattr(field, "VOLUME_CHUNK", CHUNK)
    try:
        c = _tiny(tiny_cell, tmp)
        field.reset_volume_counts()
        c.setup()
        counts = field.volume_counts()
        win = run.window(c, 0.5, trace=False)
        c.free()
        ref = c.reference()
    finally:
        mp.undo()
    return c, win, counts, checks.gaps(c.obs, ref)


def test_a_tiny_cell_at_the_configurations_voxels_agrees(tiny_run):
    c, _, counts, got = tiny_run
    assert c.cfg["mapper"]["voxel_size"] == 0.02
    assert tuple(c.obs["volumes"][0][0].shape) == (41, 41, 41)
    # the set-up query and two checked calls', each in 6 chunks
    assert counts == {"queries": 3, "chunks": 18, "voxels": 3 * 41 ** 3}
    assert checks.judge(got, TINY_AGREE), got


def test_stale_volumes_are_not_correct(tiny, tmp_path, monkeypatch):
    monkeypatch.setattr(field, "VOLUME_CHUNK", CHUNK)
    c = _tiny(tiny, tmp_path, fault="stale")
    c.setup()
    c.free()
    got = checks.gaps(c.obs, c.reference())
    assert got["volume_sdf_gap"] > STALE_SDF, got
    assert got["volume_band_gap"] > STALE_BAND, got
    assert not checks.judge(got, TINY_AGREE)


class Store:
    """Set-up's, the window's and the traced segment's volume queries (a
    CUDA event pair's ms each) and SDF host copies, as the program's span
    store holds them."""

    def __init__(self, query_ms, host_ms):
        self.query_ms = query_ms
        self.spans = [timer.Span(i, "volumes.host", 0, int(ms * 1e6), -1,
                                 -1, 1) for i, ms in enumerate(host_ms)]
        # the uncertainty volume's copies (set-up's) are not the SDF's
        self.spans.append(timer.Span(99, "volumes.host", 0, 10 ** 12, -1, -1,
                                     0))

    def records(self):
        return list(self.spans)

    def device_ms(self, name):
        return list(self.query_ms) if name == "volumes.query" else []


def _run(kind, trace=True):
    return SimpleNamespace(
        kind=kind, units="iters", cfg=config()["config"], bucket=512,
        iters=10, unit_s=[0.5, 0.5, 0.5],
        unit_device_ms=[900.0, 1000.0, 1100.0],
        traffic={"trace_units": 2},
        trace={"busy_s": 0.9, "window_s": 1.0} if trace else None)


def test_readers_read_the_windows_steps(monkeypatch):
    # 4 set-up queries, the window's 3, the traced segment's 2
    store = Store([500.0] * 4 + [600.0, 610.0, 700.0] + [5.0] * 2,
                  [50.0] * 4 + [12.0, 11.0, 30.0] + [1.0] * 2)
    monkeypatch.setattr(program_spans, "store", lambda: store)
    r = _run("mapstep")
    got = {name: run.reader(name)(r) for name in READERS}
    assert got["volume_query_ms.mapstep"] == pytest.approx(610.0)
    assert got["volume_host_ms.mapstep"] == pytest.approx(12.0)
    assert got["idle_share.mapstep"] == pytest.approx(10.0)
    f, b = work.ba_iteration_work(r.cfg, 512)
    qf, qb = volume_work.volume_query_work(r.cfg)
    least, _ = work.least_seconds(10 * f + qf, 10 * b + qb)
    assert got["mapstep_mfu"] == pytest.approx(100.0 * least / 1.0)
    assert 0 < got["mapstep_mfu"] < 100


@pytest.mark.parametrize("name", READERS)
def test_readers_read_nothing_in_a_map_run(name, monkeypatch):
    store = Store([500.0] * 10, [50.0] * 10)
    monkeypatch.setattr(program_spans, "store", lambda: store)
    assert run.reader(name)(_run("map")) is None


def test_readers_with_no_store_or_too_few_records(monkeypatch):
    monkeypatch.setattr(program_spans, "store", lambda: None)
    for name in READERS[:2]:
        assert run.reader(name)(_run("mapstep")) is None
    # a program whose store has no device spans (no device_ms) reads none
    monkeypatch.setattr(program_spans, "store",
                        lambda: SimpleNamespace(records=lambda: []))
    assert run.reader(READERS[0])(_run("mapstep")) is None
    monkeypatch.setattr(program_spans, "store",
                        lambda: Store([1.0] * 4, [1.0] * 4))
    for name in READERS[:2]:
        assert run.reader(name)(_run("mapstep")) is None


def test_the_host_copy_reader_on_a_cpu_window(tiny_run):
    """The tiny cell's window on the CPU: the program's own volumes.host
    spans, one a step; no device time there."""
    c, win, _, _ = tiny_run
    r = SimpleNamespace(kind="mapstep", units=c.units, cfg=c.cfg,
                        traffic=c.traffic, trace=None, **vars(win))
    assert len(r.unit_s) >= 1 and r.work == len(r.unit_s) * r.iters
    ms = run.reader("volume_host_ms.mapstep")(r)
    assert ms is not None and ms >= 0
    assert run.reader("volume_query_ms.mapstep")(r) is None
    assert run.reader("mapstep_mfu")(r) is None


def test_the_cell_is_in_the_manifest():
    b = run.manifest()
    entries = run.cell_entries(b, CELL)
    assert entries["cell"]["traffic"] == "mapstep"
    assert entries["cell"]["chips"] == 1
    assert [m["name"] for m in entries["end_to_end"]] == [
        "map_iters_per_s", "peak_mem_gib", "setup_s"]
    assert [m["name"] for m in entries["per_layer"]] == list(READERS)
    limits = run.load_json(os.path.join(HERE, "limits", CELL + ".json"))
    assert set(limits) == set(TINY_AGREE)
    # the committed traffic, unchanged: the map traffic's keyframes
    traffic = run.load_json(os.path.join(HERE, "traffic", "mapstep.json"))
    assert traffic["kind"] == "mapstep" and "shift" not in traffic


def test_the_recorded_path_lies_inside_the_room():
    """Every pose the traffic reads (0..500) stands inside the room's
    walls (scene.WALL_MARGIN inside the bound), 0.25 m clear at least."""
    traffic = run.load_json(os.path.join(HERE, "traffic", "mapstep.json"))
    traj = scene.load_trajectory(os.path.join(ROOT, traffic["trajectory"]))
    pos = np.stack([p[:3, 3] for p in traj[:traffic["current"] + 1]])
    bound = np.asarray(config()["config"]["mapper"]["bound"])
    lo, hi = bound[:, 0] + scene.WALL_MARGIN, bound[:, 1] - scene.WALL_MARGIN
    assert (pos - lo).min() > 0.25 and (hi - pos).min() > 0.25
