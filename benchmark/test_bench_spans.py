"""The readers of the program's own tracing (program_spans.py and its six
metrics) on a fabricated run and span store: the window's calls picked
from the store's last ones, the host path and the waits a call, each
stage's device ms an iteration; and nothing where there is no store, no
span, or no replay."""
from __future__ import annotations

from types import SimpleNamespace

import pytest

import program_spans
import run
from naruto_tpu_torch.utils import timer

HOST = ("ba_host_path_ms.map", "ba_host_waits.map")
STAGES = {"ba_sample_ms.map": "sample", "ba_forward_ms.map": "forward",
          "ba_backward_ms.map": "backward", "ba_step_ms.map": "step"}
MS = 1_000_000   # ns


class Store:
    """Spans of BA calls in the order they end, and a replay's stages."""

    def __init__(self, stages=None):
        self.spans, self.stages, self.next = [], stages, 0

    def _add(self, name, t0, t1, parent=-1, call=-1, arg=None):
        self.next += 1
        s = timer.Span(self.next, name, t0, t1, parent, call, arg)
        self.spans.append(s)
        return s

    def call(self, t0, wait_end, launch_end, waits=1):
        """A ba.call from t0 whose last wait ends at wait_end and whose
        launch ends at launch_end (ms), the rest as the program nests
        them."""
        cid = self.next + 1000
        self.next = cid
        for k in range(waits):
            self._add("ba.wait", (t0 + 0.1 + k * 0.01) * MS,
                      (wait_end - (waits - 1 - k) * 0.01) * MS, cid, cid)
        self._add("ba.inputs", t0 * MS, (wait_end + 0.05) * MS, cid, cid)
        self._add("ba.draws", (wait_end + 0.05) * MS, (wait_end + 2) * MS,
                  cid, cid)
        self._add("ba.launch", (launch_end - 1) * MS, launch_end * MS, cid,
                  cid)
        self._add("ba.done", launch_end * MS, (launch_end + 0.1) * MS, cid,
                  cid)
        self.spans.append(timer.Span(cid, "ba.call", t0 * MS,
                                     (launch_end + 0.2) * MS, -1, cid, 512))

    def records(self):
        return list(self.spans)

    def stage_ms(self):
        return self.stages


def _run(n_window, traced=2, **kw):
    return SimpleNamespace(kind="map", unit_s=[0.03] * n_window,
                           traffic={"trace_units": traced}, iters=10, **kw)


@pytest.fixture
def fabricated(monkeypatch):
    """A store of 2 set-up calls, 4 window calls and 2 traced ones, and
    a replay's stage sums over 10 iterations."""
    store = Store({"sample": 2.0, "forward": 9.0, "backward": 12.0,
                   "step": 5.0})
    store.call(0, 20, 25, waits=4)                 # the warm-up's call
    store.call(30, 40, 41)
    for k, path in enumerate((3.0, 5.0, 4.0, 6.0)):      # the window
        t = 100 + 40 * k
        store.call(t, t + 10, t + 10 + path)
    store.call(300, 310, 390)                     # traced: slower
    store.call(400, 410, 490)
    monkeypatch.setattr(timer, "SPANS", store)
    return store


def test_window_calls_are_the_last_less_the_traced(fabricated):
    calls = program_spans.window_calls(_run(4))
    assert [c[-1].start_ns for c in calls] == [t * MS for t in
                                               (100, 140, 180, 220)]
    assert all(c[-1].name == "ba.call" for c in calls)
    assert all({r.call for r in c} == {c[-1].id} for c in calls)
    # more window calls than the store holds: nothing
    assert program_spans.window_calls(_run(7)) is None


def test_host_path_is_the_median_from_the_last_wait_to_the_launch(
        fabricated, monkeypatch):
    assert run.reader("ba_host_path_ms.map")(_run(4)) == pytest.approx(4.5)
    # a call with no wait is timed from its start
    store = Store()
    store.call(0, 10, 13, waits=0)
    monkeypatch.setattr(timer, "SPANS", store)
    assert run.reader("ba_host_path_ms.map")(_run(1, traced=0)) == \
        pytest.approx(13.0)


def test_host_waits_a_window_call(fabricated):
    assert run.reader("ba_host_waits.map")(_run(4)) == 1.0
    # the warm-up's call, with its four waits, in the window
    assert run.reader("ba_host_waits.map")(_run(6)) == pytest.approx(
        (4 + 1 + 4) / 6)


@pytest.mark.parametrize("name", list(STAGES))
def test_stage_ms_an_iteration(fabricated, name):
    want = fabricated.stages[STAGES[name]] / 10
    assert run.reader(name)(_run(4)) == pytest.approx(want)


@pytest.mark.parametrize("name", HOST + tuple(STAGES))
def test_nothing_to_read_gives_nothing(monkeypatch, name):
    reader = run.reader(name)
    # no store: a program without span tracing
    monkeypatch.delattr(timer, "SPANS")
    assert reader(_run(4)) is None
    # a store with no call and no replay (the CPU's eager BA)
    monkeypatch.setattr(timer, "SPANS", Store(), raising=False)
    assert reader(_run(4)) is None
    # the program's own store on the CPU
    monkeypatch.setattr(timer, "SPANS", timer.SpanStore())
    assert reader(_run(4)) is None
    # another kind of cell, or a window with no call
    store = Store({"sample": 1.0, "forward": 1.0, "backward": 1.0,
                   "step": 1.0})
    store.call(0, 1, 2)
    monkeypatch.setattr(timer, "SPANS", store)
    other = _run(1, traced=0)
    other.kind = "other"
    assert reader(other) is None
    if name in HOST:
        assert reader(_run(0, traced=0)) is None
