"""The work counts against the bounds PERF.md states for the kernel sites,
and the BA iteration's counts from the configurations' shapes."""
from __future__ import annotations

import json
import os

import pytest

import work
from reference import Grid

HERE = os.path.dirname(os.path.abspath(__file__))


def cfg(name):
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        return json.load(f)["config"]


def ms(nbytes):
    return nbytes / work.PEAK_BYTES_S * 1e3


def test_outer_scan_slots_bound():
    # PERF.md: [493,568 x (8 + 8)] bf16 into [204,089, 64] at 0.0209 ms
    assert round(ms(work.outer_scan_slots_bytes(493_568, 8, 8, 204_089)),
                 4) == 0.0209


def test_vertex_segment_sum_bound():
    # PERF.md: [15,789,952, 2] -> 814,897 fed the permutation at 0.0962 ms
    assert round(ms(work.vertex_segment_sum_bytes(15_789_952, 2, 814_897)),
                 4) == 0.0962


def test_sites_at_the_configurations_shapes():
    h, p = cfg("office0_hybrid"), cfg("office0_parity")
    assert work.ba_points(h, 512) == (2176, 93_568, 29_791)
    assert Grid(h).total == 204_089 and Grid(p).total == 814_897
    hb = work.site_bytes(h, 512)["outer_scan_slots"]
    assert hb == work.outer_scan_slots_bytes(123_359 * 4, 8, 8, 204_089)
    assert round(ms(hb), 4) == 0.0209
    pb = work.site_bytes(p, 512)["sorted_segment_sum"]
    assert pb == work.vertex_segment_sum_bytes(15_789_952, 2, 814_897)


@pytest.mark.parametrize("name,bound", [("office0_hybrid", "bytes"),
                                        ("office0_parity", "flops")])
def test_ba_iteration_least_time(name, bound):
    flops, nbytes = work.ba_iteration_work(cfg(name), 512)
    # the MLPs: 6 x 93,568 points x 5,184 multiply-adds a point
    assert flops > 6 * 93_568 * 5_184
    least, by = work.least_seconds(flops, nbytes)
    assert by == bound and 1e-5 < least < 1e-4
