"""The plain reference against the port at a tiny size on the CPU, and the
faults a cell can have turning ``correct`` false.

Each cell runs the program's set-up and checked calls, then the
reference on the same weights, frames and draws; the numbers compared
(checks.py) are small for the program as it is and cross the cell's
limits (benchmark/limits/) when the timed path is broken underneath: a
mapping call that leaves the state unchanged, and every other ray of
each batch left out.
"""
from __future__ import annotations

import json
import os

import pytest

import checks
from conftest import CELLS, HERE

# the tiny size's agreement: tables of 4,096 rows a level take the same
# rays far more often than the full size's, so the cell rows' prefix-sum
# backward rounds more of them differently (a full size's readings and
# limits are in PERF.md)
TINY_AGREE = {"first_loss_gap": 1e-6, "loss_gap": 5e-3, "moment_gap": 2e-2,
              "change_gap": 0.3}
FAULTS = ("state", "half")


def limits(cell):
    with open(os.path.join(HERE, "limits", cell + ".json")) as f:
        return json.load(f)


def numbers(tiny, cell, tmp, fault=None, seed=7):
    c = tiny(cell, seed, str(tmp), fault=fault)
    c.setup()
    c.free()
    return checks.gaps(c.obs, c.reference())


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
