"""The plain reference against the port at a tiny size on the CPU, and the
faults a cell can have turning ``correct`` false.

Each cell runs the program's set-up and checked calls, then the
reference on the same weights, frames and draws; the numbers compared
(checks.py) are small for the program as it is and cross the cell's
limits (benchmark/limits/) when the timed path is broken underneath: a
mapping call that leaves the state unchanged, and every other ray of
each batch left out. The ``mapstep`` kind's map volumes are held to the
reference's too: equal observations read nought, and volumes a step late
read far off.
"""
from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

import checks
from conftest import CELLS, HERE

# the tiny size's agreement: tables of 4,096 rows a level take the same
# rays far more often than the full size's, so the cell rows' prefix-sum
# backward rounds more of them differently (a full size's readings and
# limits are in PERF.md)
TINY_AGREE = {"first_loss_gap": 1e-6, "loss_gap": 5e-3, "moment_gap": 2e-2,
              "change_gap": 0.3}
FAULTS = ("state", "half")
# the mapping-step kind on both configurations (no cell of BENCHMARK.json
# yet), with calls of 5 iterations so that the uncertainty grid steps; its
# volumes at the tiny size, seeds 7-9: equal bit for bit at the initial
# weights; after training the hybrid table departs as above, so its SDF
# departs by up to 3.7% of the reference's norm (parity 0.045%), up to
# 3.3% of the voxels change sides of the surface band (parity 0.027%) and
# the uncertainty where both sides place a voxel in the band departs by
# up to 1.6% of its norm (parity 2.7e-6)
MAPSTEP = ("office0_hybrid.mapstep", "office0_parity.mapstep")
TINY_VOLUMES = {"volume_sdf_gap": 0.1, "volume_band_gap": 0.1,
                "volume_uncert_gap": 0.05, "volume_first_gap": 1e-6}
# volumes one mapping step late: the field moves between calls by far more
# than the program departs from the reference (seeds 7-9: SDF gap
# 0.95-1.07 against the program's 0.037 at most; band gap 0.64-0.82
# against 0.033)
STALE_SDF = 0.3
# metres added to every pose of the path: inside office0's room (the
# traffic key that places the path in another scene's room)
SHIFT = [0.1, -0.05, 0.05]


def limits(cell):
    with open(os.path.join(HERE, "limits", cell + ".json")) as f:
        return json.load(f)


def observed(tiny, cell, tmp, fault=None, seed=7, traffic=None):
    """The opened cell's observations and the numbers compared."""
    c = tiny(cell, seed, str(tmp), fault=fault, traffic=traffic)
    c.setup()
    c.free()
    return c, checks.gaps(c.obs, c.reference())


def numbers(tiny, cell, tmp, fault=None, seed=7):
    return observed(tiny, cell, tmp, fault=fault, seed=seed)[1]


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_port(tiny, cell, tmp_path):
    got = numbers(tiny, cell, tmp_path)
    for k, v in TINY_AGREE.items():
        assert got[k] < v, (k, got)


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS
                                        for f in FAULTS])
def test_a_broken_timed_path_is_not_correct(tiny, cell, fault, tmp_path):
    got = numbers(tiny, cell, tmp_path, fault=fault)
    assert not checks.judge(got, limits(cell)), got


@pytest.mark.parametrize("cell", MAPSTEP)
def test_a_mapping_step_agrees_with_the_reference(tiny, cell, tmp_path):
    c, got = observed(tiny, cell, tmp_path)
    assert checks.judge(got, {**TINY_AGREE, **TINY_VOLUMES}), got
    # the uncertainty grid stepped: where a voxel is in the band at set-up
    # and after the last call, its uncertainty moved
    (s0, u0), (s1, u1) = c.obs["volumes"][0], c.obs["volumes"][-1]
    both = checks._band(s0) & checks._band(s1)
    assert bool(both.any()) and bool((u1[both] != u0[both]).any())


@pytest.mark.parametrize("cell", MAPSTEP)
def test_stale_volumes_are_not_correct(tiny, cell, tmp_path):
    got = numbers(tiny, cell, tmp_path, fault="stale")
    assert got["volume_sdf_gap"] > STALE_SDF, got
    assert not checks.judge(got, {**TINY_AGREE, **TINY_VOLUMES}), got


def test_a_shifted_path_agrees_with_the_reference(tiny, tmp_path):
    # parity's grid: its program agrees with the reference to 1e-4
    cell = "office0_parity.mapstep"
    c, got = observed(tiny, cell, tmp_path, traffic={"shift": SHIFT})
    plain = tiny(cell, 7, str(tmp_path))
    moved = np.stack([p[:3, 3] - q[:3, 3] for p, q in zip(c.traj,
                                                          plain.traj)])
    assert np.allclose(moved, np.float32(SHIFT), atol=1e-6)
    assert checks.judge(got, {**TINY_AGREE, **TINY_VOLUMES}), got


def test_volume_numbers_read_nought_on_equal_observations():
    g = torch.Generator().manual_seed(3)
    vols = [(torch.rand(6, 5, 4, generator=g) - 0.3,
             torch.rand(6, 5, 4, generator=g)) for _ in range(3)]
    base = {"losses": [[{"total": 1.0, "rgb_loss": 0.5}]],
            "moments": [torch.ones(3), torch.ones(2)],
            "params": [torch.ones(3), torch.ones(2)],
            "init": [torch.zeros(3), torch.zeros(2)]}
    obs = dict(base, volumes=vols)
    same = checks.gaps(obs, dict(obs, volumes=[(s.clone(), u.clone())
                                               for s, u in vols]))
    assert {k: same[k] for k in TINY_VOLUMES} == dict.fromkeys(TINY_VOLUMES,
                                                               0.0)
    # absent where either side carries no volumes
    for prog, ref in ((obs, base), (base, obs), (base, base)):
        assert not set(checks.gaps(prog, ref)) & set(TINY_VOLUMES)
    # the set-up volume alone makes the first gap
    first = [(vols[0][0] * 1.5, vols[0][1])] + vols[1:]
    assert checks.gaps(dict(obs, volumes=first), obs)["volume_first_gap"] \
        == pytest.approx(0.5)
    # in the last volume, one voxel taken to the other side of the band
    # and the uncertainty of one that stays inside moved
    ref = obs["volumes"][2]
    s, u = (t.clone() for t in ref)
    inside = (ref[0] >= 0.0) & (ref[0] < 0.5)
    s[0, 0, 0] = -0.25 if inside[0, 0, 0] else 0.25
    stay = [i for i in range(1, 120) if inside.flatten()[i]][0]
    u.view(-1)[stay] += 1.0
    moved = checks.gaps(dict(obs, volumes=vols[:2] + [(s, u)]), obs)
    assert moved["volume_band_gap"] == pytest.approx(1 / 120)
    assert moved["volume_sdf_gap"] == pytest.approx(
        float((s[0, 0, 0] - ref[0][0, 0, 0]).abs() / ref[0].norm()))
    both = checks._band(ref[0]) & checks._band(s)
    assert moved["volume_uncert_gap"] == pytest.approx(
        1.0 / float(ref[1][both].norm()))
    assert moved["volume_first_gap"] == 0.0
