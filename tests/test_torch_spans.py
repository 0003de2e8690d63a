"""The port's spans and counters on the CPU (naruto_tpu_torch/utils/timer.py,
mapping/ba_graph.py): nesting, parents and call ids, the ring's bound, no
torch call while no profiler records, the spans as user annotations under
torch.profiler, the Timer's sections as spans, the BA call's span tree in
the eager form and in the graph form (its capture faked: the CPU captures
nothing), and the graph counters a bucket. The stage events inside a
captured graph: tests/test_torch_cuda.py."""
import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

from naruto_tpu_torch.config import make_config
from naruto_tpu_torch.mapping import ba_graph
from naruto_tpu_torch.mapping.mapper import CUR_BUCKETS, Mapper
from naruto_tpu_torch.utils import timer
from naruto_tpu_torch.utils.timer import SPANS, SpanStore, Timer, span

torch.set_num_threads(1)

BOUND = ((-2.0, 2.0), (-2.0, 2.0), (-2.0, 2.0))
ITERS = 3


def _cfg():
    return make_config("Replica", "office0", num_iter=40, overrides={
        "cam": {"H": 24, "W": 32, "fx": 20.0, "fy": 20.0, "cx": 15.5,
                "cy": 11.5, "far": 5.0},
        "grid": {"n_levels": 4, "hash_size": 12, "voxel_sdf": 0.1},
        "mapper": {"sample": 64, "iters": ITERS, "first_iters": 2,
                   "min_pixels_cur": 4, "act_ray_num_uncert_sample": 8,
                   "uncert_accum_iters": 2, "bound": BOUND,
                   "marching_cubes_bound": BOUND, "voxel_size": 0.5},
        "training": {"n_samples_d": 8, "n_range_d": 5, "smooth_pts": 4}})


def _frame(seed):
    rng = np.random.default_rng(seed)
    depth = rng.uniform(0.5, 3.0, (24, 32)).astype(np.float32)
    depth[:3] = 0.0
    return rng.uniform(0, 1, (24, 32, 3)).astype(np.float32), depth


def _pose(i):
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.02 * i, -0.01 * i, 0.0]
    return torch.from_numpy(c2w)


@pytest.fixture(scope="module")
def mapper():
    """A CPU mapper after its first frame, two more keyframes and a volume
    query."""
    m = Mapper(_cfg(), device="cpu")
    m.update_step(0)
    m.online_recon_step(0, *_frame(0), _pose(0).numpy())
    for s in (5, 10):
        m.poses[s] = _pose(s)
        m.add_keyframe(m.frame_to_rays(*_frame(s)), s)
    m.map_volumes()
    return m


def _calls(records):
    """{call id: that call's spans}, in the order they ended."""
    out = {}
    for r in records:
        if r.call >= 0:
            out.setdefault(r.call, []).append(r)
    return out


def _tree(spans):
    """The (parent name, name) edges of one call's spans, each once."""
    by_id = {r.id: r for r in spans}
    return {(by_id[r.parent].name if r.parent in by_id else None, r.name)
            for r in spans}


def _last_call(before: int):
    """The spans of the one call recorded after span id `before`."""
    calls = _calls([r for r in SPANS.records() if r.id > before])
    assert len(calls) == 1
    return next(iter(calls.values()))


def _next_id() -> int:
    with span("mark") as s:
        return s.id


# ------------------------------------------------------------- the store
def test_nesting_parents_and_call_ids():
    """A span's parent is the innermost span open on its thread; a span
    opened with call=True starts a call that every span inside it shares;
    the records come in the order the spans ended, with their times."""
    store = SpanStore()
    with store.open("outer"):
        with store.open("a.call", 512, call=True) as c:
            with store.open("child") as ch:
                with store.open("grandchild"):
                    pass
            with store.open("sibling"):
                pass
        with store.open("after"):
            pass
    rec = {r.name: r for r in store.records()}
    assert [r.name for r in store.records()] == [
        "grandchild", "child", "sibling", "a.call", "after", "outer"]
    assert rec["outer"].parent == -1 and rec["outer"].call == -1
    assert rec["a.call"].parent == rec["outer"].id
    assert rec["a.call"].call == c.id and rec["a.call"].arg == 512
    assert rec["child"].parent == c.id and rec["sibling"].parent == c.id
    assert rec["grandchild"].parent == ch.id
    assert {rec[n].call for n in ("child", "grandchild", "sibling")} == {c.id}
    assert rec["after"].call == -1
    for r in store.records():
        assert r.start_ns <= r.end_ns
    assert rec["outer"].start_ns <= rec["a.call"].start_ns
    assert rec["a.call"].end_ns <= rec["after"].start_ns


def test_ring_keeps_the_last_capacity():
    """The store is bounded: it keeps its last `capacity` records."""
    store = SpanStore(capacity=8)
    for i in range(20):
        with store.open(f"s{i}"):
            pass
    assert [r.name for r in store.records()] == [f"s{i}" for i in
                                                 range(12, 20)]
    assert timer.CAPACITY >= 1 << 16


def test_threads_keep_their_own_parents():
    """Threads that open spans at once each nest under their own spans,
    and no record is lost (a short switch interval, more threads than
    cores)."""
    store = SpanStore()
    n_threads, reps = 16, 200
    interval = sys.getswitchinterval()

    def work(k):
        for _ in range(reps):
            with store.open(f"t{k}"):
                with store.open(f"t{k}.inner"):
                    pass

    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    recs = store.records()
    assert len(recs) == 2 * n_threads * reps
    by_id = {r.id: r for r in recs}
    for r in recs:
        if r.name.endswith(".inner"):
            assert by_id[r.parent].name + ".inner" == r.name
        else:
            assert r.parent == -1


def test_no_torch_call_while_no_profiler_records():
    """With no profiler recording, opening and closing a span calls
    nothing of torch, from Python or C."""
    store = SpanStore()
    torch_dir = os.path.dirname(torch.__file__)
    calls, c_calls = [], []

    def hook(frame, event, arg):
        if event == "call":
            calls.append(frame.f_code.co_filename)
        elif event == "c_call":
            c_calls.append(getattr(arg, "__module__", None) or type(
                getattr(arg, "__self__", None)).__module__)

    assert not torch.autograd.profiler._is_profiler_enabled
    sys.setprofile(hook)
    try:
        with store.open("quiet"):
            with store.open("inner"):
                pass
    finally:
        sys.setprofile(None)
    assert calls and c_calls
    assert not [f for f in calls if f.startswith(torch_dir)], calls
    assert not [m for m in c_calls if m.split(".")[0] == "torch"], c_calls
    assert [r.name for r in store.records()] == ["inner", "quiet"]


def test_spans_are_user_annotations_under_the_profiler(tmp_path):
    """Under a torch.profiler session each span also lands in the trace as
    a user annotation inside the session's window, by its name, nested as
    its parents are; the store records it as ever."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(32, 32)
    store = SpanStore()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        x.add(1.0)
        with store.open("ba.call", 512, call=True):
            with store.open("ba.inputs"):
                with store.open("ba.wait"):
                    (x @ x).sum()
            with store.open("ba.launch"):
                x.mul(2.0)
        x.sub(1.0)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ann = {e["name"]: e for e in events if e.get("cat") == "user_annotation"}
    assert set(ann) >= {"ba.call", "ba.inputs", "ba.wait", "ba.launch"}
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    # the session's first and last operators, outside every span
    add = next(e for e in ops if e["name"] == "aten::add")
    sub = next(e for e in ops if e["name"] == "aten::sub")
    lo, hi = add["ts"] + add["dur"], sub["ts"]

    def inside(a, b):
        return b["ts"] <= a["ts"] and a["ts"] + a["dur"] <= b["ts"] + b["dur"]

    for e in ann.values():
        assert lo <= e["ts"] and e["ts"] + e["dur"] <= hi
    assert inside(ann["ba.wait"], ann["ba.inputs"])
    assert inside(ann["ba.inputs"], ann["ba.call"])
    assert inside(ann["ba.launch"], ann["ba.call"])
    assert ann["ba.inputs"]["ts"] + ann["ba.inputs"]["dur"] <= \
        ann["ba.launch"]["ts"]
    mm = next(e for e in ops if e["name"] == "aten::mm")
    assert inside(mm, ann["ba.wait"])
    rec = {r.name: r for r in store.records()}
    assert rec["ba.wait"].parent == rec["ba.inputs"].id
    assert rec["ba.inputs"].parent == rec["ba.call"].id


def test_timer_sections_are_spans(capsys):
    """The Timer's sections are spans, nested as they were opened and
    timed by the span's clock; its summary prints as it did."""
    t = Timer()
    before = _next_id()
    with t.time("SLAM", "General"):
        with t.time("ba_dispatch", "Mapper"):
            pass
        t.start("keyframe_add", "Mapper")
        t.end("keyframe_add")
    recs = {r.name: r for r in SPANS.records() if r.id > before}
    assert recs["ba_dispatch"].parent == recs["SLAM"].id
    assert recs["keyframe_add"].parent == recs["SLAM"].id
    assert t.get_last_timing("SLAM") == pytest.approx(
        (recs["SLAM"].end_ns - recs["SLAM"].start_ns) * 1e-9)
    assert t.groups == {"SLAM": "General", "ba_dispatch": "Mapper",
                        "keyframe_add": "Mapper"}
    t.timings = {"SLAM": [0.5, 0.25, 1.0], "Simulation": [0.125],
                 "ba_dispatch": [0.01, 0.02], "keyframe_add": []}
    t.groups["Simulation"] = "General"
    t.time_analysis()
    want = "\n".join([
        "=" * 60, "Timing analysis (seconds)", "=" * 60, "[General]",
        f"  {'SLAM':<28s} n={3:<6d} median=0.5000 mean=0.5833 total=1.75",
        f"  {'Simulation':<28s} n={1:<6d} median=0.1250 mean=0.1250 "
        "total=0.12",
        "[Mapper]",
        f"  {'ba_dispatch':<28s} n={2:<6d} median=0.0150 mean=0.0150 "
        "total=0.03",
        "=" * 60])
    assert capsys.readouterr().out == want + "\n"


def test_stage_marks_only_inside_a_capture():
    """stage() does nothing outside stage_events() (the eager call, the
    warm-up, the CPU), and the store reads no stage time where no program
    with marks has replayed."""
    store = SpanStore()
    store.stage("sample")
    assert store._stages is None and store.stage_ms() is None
    with store.stage_events() as marks:
        assert marks == [] and store._stages is marks
    assert store._stages is None


# ------------------------------------------------------------ the BA call
def test_eager_ba_call_span_tree(mapper):
    """An eager BA call on the CPU: ba.call (carrying the bucket) > ba.inputs
    > ba.wait, the call's one wait, and ba.call > ba.draws an iteration; no
    stage marks are kept."""
    before = _next_id()
    SPANS.replayed = None
    mapper._ba_impl(512, mapper.frame_to_rays(*_frame(15)), _pose(15), 15)
    spans = _last_call(before)
    call = spans[-1]
    assert call.name == "ba.call" and call.arg == 512
    assert call.parent == -1
    assert _tree(spans) == {(None, "ba.call"), ("ba.call", "ba.inputs"),
                            ("ba.inputs", "ba.wait"), ("ba.call", "ba.draws")}
    assert [r.name for r in spans].count("ba.wait") == 1
    assert [r.name for r in spans].count("ba.draws") == ITERS
    assert SPANS.replayed is None


class _FakeGraph:
    """Replays a program by running it (the CPU captures nothing)."""

    def __init__(self, prog):
        self.prog = prog

    def replay(self):
        outs = self.prog.run()
        self.prog._flat.copy_(torch.stack([v for a in outs
                                           for v in a.values()]))


def _fake_capture(self, pool, stream):
    outs = self.run()
    self._keys = [list(a) for a in outs]
    self._flat = torch.stack([v for a in outs for v in a.values()])
    self.graph = _FakeGraph(self)


@pytest.fixture
def graph_mapper(monkeypatch):
    """A CPU mapper whose BA calls go through BAGraphs, its capture
    faked."""
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(ba_graph, "capture_stream", lambda device: None)
    monkeypatch.setattr(ba_graph._Program, "capture", _fake_capture)
    m = Mapper(_cfg(), device="cpu")
    m.update_step(0)
    m.online_recon_step(0, *_frame(0), _pose(0).numpy())
    m.map_volumes()
    m._ba_graphs = ba_graph.BAGraphs(m)
    return m


def _graph_call(m, bucket, k):
    return m._ba_impl(bucket, m.frame_to_rays(*_frame(15 + k)),
                      _pose(15 + k), 15 + k)


def test_graph_ba_call_span_tree(graph_mapper):
    """The graph form's call: the first one warms every bucket up and
    captures its own; each has ba.inputs > ba.wait, ba.draws, ba.load,
    ba.launch, ba.outputs and ba.done under ba.call, in that order, and a
    later call of the bucket exactly one ba.wait."""
    m = graph_mapper
    before = _next_id()
    _graph_call(m, 512, 0)
    first = _last_call(before)
    assert ("ba.call", "ba.warm_up") in _tree(first)
    assert ("ba.call", "ba.capture") in _tree(first)
    assert ("ba.warm_up", "ba.wait") in _tree(first)
    warm = [r for r in first if r.name == "ba.warm_up"]
    assert [r.name for r in first if r.parent == warm[0].id].count(
        "ba.inputs") == len(CUR_BUCKETS)
    before = _next_id()
    _graph_call(m, 512, 1)
    spans = _last_call(before)
    call = spans[-1]
    assert call.name == "ba.call" and call.arg == 512
    children = sorted((r for r in spans if r.parent == call.id),
                      key=lambda r: r.start_ns)
    assert [r.name for r in children] == [
        "ba.inputs", "ba.draws", "ba.load", "ba.launch", "ba.outputs",
        "ba.done"]
    assert _tree(spans) == {(None, "ba.call"), ("ba.inputs", "ba.wait")} | {
        ("ba.call", r.name) for r in children}
    assert [r.name for r in spans].count("ba.wait") == 1
    for a, b in zip(children, children[1:]):
        assert a.end_ns <= b.start_ns
    assert SPANS.replayed == []


def test_graph_counters_by_bucket(graph_mapper):
    """GRAPH_COUNTS: the calls, replays and captures of each bucket, and
    the one warm-up of every bucket at the mapper's first call; the eager
    call counts nothing."""
    m = graph_mapper
    ba_graph.reset_graph_counts()
    for k, bucket in enumerate((512, 512, 2048, 512)):
        _graph_call(m, bucket, k)
    m._ba_impl_eager(2048, m.frame_to_rays(*_frame(30)), _pose(30), 30)
    zero = dict.fromkeys(("calls", "replays", "captures", "warm_ups"), 0)
    assert ba_graph.graph_counts() == {
        512: dict(zero, calls=3, replays=3, captures=1, warm_ups=1),
        2048: dict(zero, calls=1, replays=1, captures=1, warm_ups=1),
        8192: dict(zero, warm_ups=1)}
    ba_graph.reset_graph_counts()
    assert ba_graph.graph_counts() == {}
