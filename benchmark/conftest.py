"""The benchmark's CPU tests: the cells at a tiny size (24x32 frames, a
12-bit table, small batches), one thread a worker."""
from __future__ import annotations

import os
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for _p in (ROOT, HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)

torch.set_num_threads(1)

# the sizes of the port's own CPU tests (tests/test_torch_engine.py)
TINY = {"cam": {"H": 24, "W": 32, "fx": 16.0, "fy": 16.0, "cx": 15.5,
                "cy": 11.5},
        "sim": {"pinhole_hw": [24, 32], "erp_hw": [16, 32]},
        "grid": {"hash_size": 12},
        "mapper": {"sample": 64, "iters": 2, "first_iters": 8,
                   "min_pixels_cur": 8, "act_ray_num_uncert_sample": 16},
        "training": {"n_range_d": 5, "n_samples_d": 8, "smooth_pts": 8}}
TINY_TRAFFIC = {k: {"keyframes": {"first": 0, "every": 5, "count": 4},
                    "current": 20, "checked_calls": 2}
                for k in ("map", "mapstep")}
# a kind's own sizes: a mapping step's calls long enough for the
# uncertainty grid to step (every uncert_accum_iters = 5th iteration)
TINY_KIND = {"map": {}, "mapstep": {"mapper": {"iters": 5}}}
# <configuration>.<traffic>: the cells of BENCHMARK.json
CELLS = ("office0_hybrid.map", "office0_parity.map")


def tiny_cell(cell: str, seed: int, tmp: str, fault=None, traffic=None):
    """The cell <configuration>.<traffic> on the CPU at the tiny size;
    `traffic`: keys merged into the traffic file's."""
    import cells
    import run

    config, name = cell.split(".")
    cfg = run.load_json(os.path.join(HERE, "configs", config + ".json"))
    given = run.load_json(os.path.join(HERE, "traffic", name + ".json"))
    given = cells.merged(cells.merged(given, TINY_TRAFFIC[name]),
                         traffic)
    config = cells.merged(cells.merged(cfg["config"], TINY), TINY_KIND[name])
    return cells.kind(given["kind"], ROOT)(
        config, given, seed, "cpu", ROOT, tmp, fault=fault)


@pytest.fixture
def tiny():
    return tiny_cell
