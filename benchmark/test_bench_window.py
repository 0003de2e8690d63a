"""The window's arithmetic: a rate is all the work over all the window's
time; and the metric readers on it."""
from __future__ import annotations

import time
from types import SimpleNamespace

import pytest
import torch

import cells
import run
import tracing


class Clocked(cells.Cell):
    """A cell whose units take the given seconds in turn."""

    def __init__(self, durations, work=10):
        self.durations, self.k = durations, 0
        self.dev = torch.device("cpu")
        self.work, self.unit_s, self.events = 0, [], None
        self.per = work
        self.opened = 0

    def begin_window(self):
        self.opened += 1

    def readings(self):
        return {"opened": self.opened}

    def unit(self):
        d = self.durations[self.k % len(self.durations)]
        self.k += 1
        t0 = time.perf_counter()
        time.sleep(d)
        self.unit_s.append(time.perf_counter() - t0)
        self.work += self.per


def test_rate_is_all_work_over_all_window_time():
    cell = Clocked([0.01, 0.03])
    win = run.window(cell, 0.3, trace=False)
    assert win.work == 10 * len(win.unit_s)
    # every unit the window ran counts, the last one that crossed the
    # deadline included, over the time until it ended
    assert win.elapsed_s >= 0.3 and win.elapsed_s >= sum(win.unit_s)
    rate = run.reader("map_iters_per_s")(SimpleNamespace(kind="map",
                                                         units="iters",
                                                         **vars(win)))
    assert rate == pytest.approx(win.work / win.elapsed_s)
    assert rate < 10 / 0.01
    # the kind's own readings ride beside the clock, taken once
    assert win.opened == 1


@pytest.mark.parametrize("name,kind", [
    ("map_iters_per_s", "other"), ("ba_host_ms.map", "other"),
    ("ba_device_ms.map", "map"), ("map_step_mfu", "map"),
    ("idle_share.map", "map"), ("outer_scan_slots_roofline", "map"),
    ("sorted_segment_sum_roofline", "map")])
def test_a_reader_with_nothing_to_read_returns_nothing(name, kind):
    r = SimpleNamespace(kind=kind, units="iters" if kind == "map" else
                        "calls", unit_s=[], unit_device_ms=[], trace=None,
                        work=0, elapsed_s=1.0)
    assert run.reader(name)(r) is None


def test_trace_summary_busy_idle_and_gaps():
    ev = [{"cat": "user_annotation", "name": tracing.SEGMENT, "ts": 0,
           "dur": 1000},
          {"cat": "kernel", "name": "void a<1>(int)", "ts": 100, "dur": 200},
          {"cat": "kernel", "name": "void a<1>(int)", "ts": 250, "dur": 150},
          {"cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 700, "dur": 100},
          {"cat": "kernel", "name": "late", "ts": 1500, "dur": 10},
          {"cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 400,
           "dur": 290},
          {"cat": "cpu_op", "name": "aten::add", "ts": 0, "dur": 95}]
    s = tracing.summarize(ev)
    assert s["window_s"] == pytest.approx(1e-3)
    assert s["busy_s"] == pytest.approx(400e-6)
    assert s["kernels"]["void a<1>(int)"] == [2, pytest.approx(350e-6)]
    assert s["idle_gaps"]["cudaStreamSynchronize"] == pytest.approx(300e-6)
    assert s["idle_gaps"]["aten::add"] == pytest.approx(100e-6)
    b = tracing.breakdown(s)
    assert b["device_ops"][0][0] == "a"
    assert tracing.kernel_time(s, "a<") == (2, pytest.approx(350e-6))
    assert tracing.kernel_time(s, "nothing") is None
    r = SimpleNamespace(kind="map", units="iters", trace=s)
    assert run.reader("idle_share.map")(r) == pytest.approx(60.0)
