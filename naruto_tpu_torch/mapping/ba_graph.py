"""The BA call as one captured CUDA graph per ``cur_cap`` bucket
(counterpart of ``_get_ba_jit`` / ``_ba_jits`` in
naruto_tpu/mapping/mapper.py: one XLA program per bucket holding the whole
call, ``mapper.iters`` iterations in a ``lax.scan``).

The eager call (``Mapper._ba_impl_eager``) enqueues some 580 device
operations an iteration from Python, and the card waits for the host. Here
a bucket's call is captured once into a ``torch.cuda.CUDAGraph``, and each
later call is one graph launch:

  * Static inputs. The frame's rays, its valid-pixel order, the current
    pose, the host integers as device scalars (``num_cur``, the keyframe
    count of the pose slot mask), the optimizer scalars
    (mapping/optim.py) and every iteration's draws live in the program's
    own buffers, and a call copies its inputs into them. The draws are
    made eagerly before the launch, by ``Mapper._draw_ba``: each site has
    its own generator, so drawing a call's draws first gives the
    interleaved draws of the eager call bit for bit. ``randint``'s host
    bounds (the valid pixels, the keyframe rays) stay on the host.
  * Everything else the call reads or writes (the field, the optimizer
    states, the keyframe rays, the pose table, the uncertainty volume and
    its gradient sum, the pose variables) keeps its address for the
    mapper's life: the mapper writes all of it in place.
  * The mapper's first call warms every bucket's program up: each runs once
    uncaptured on the capture stream, on draws of generators of its own,
    and the state it steps is put back. That builds the kernels, sizes
    their look-back state (ops/kernels.py ``scan_state``) and the library
    workspaces for that stream, and fills the device-constant cache, all
    before the first capture, whose memory pool then never holds beside a
    warm-up's memory. A bucket's program is captured at the bucket's first
    call; every call, that one included, is one replay. A failed capture
    raises and leaves the state as it was, and every later call of the
    bucket raises too: no call runs eagerly in a graph's place.
  * All buckets' graphs share one memory pool and replay one after another
    on the caller's stream; every mapper's warm-ups and captures run on one
    stream of the device's. The static inputs but the draws are shared by
    the buckets' programs.
  * Launch accounting: the capture counts each iteration's kernel launches
    apart (ops/kernels.py ``capturing``), and each replay adds them to the
    counts of launches that ran. ``GRAPH_COUNTS`` counts the calls, the
    replays, the captures and the warm-up runs of each bucket.
  * Tracing: a call is a ``ba.call`` span (utils/timer.py) whose children
    are its phases on the host: ``ba.warm_up`` and ``ba.capture`` where
    they happen, ``ba.inputs`` (with ``ba.wait``, the call's one wait for
    the device), ``ba.draws``, ``ba.load`` (the static-buffer copies),
    ``ba.launch``, ``ba.outputs`` and ``ba.done``. Every host wait on the
    call's path is a ``ba.wait``. Inside the graph, timing events mark the
    call's start and the end of each iteration's stages (``sample``,
    ``forward``, ``backward``, ``step``): 1 + 4 x iters event nodes, whose
    device times ``SPANS.stage_ms()`` reads after a replay.
  * The losses: one flat tensor of every iteration's aux values, which
    each replay rewrites; a call returns dicts of views into a copy of it.

The optimizers' host counts advance after each call (``Mapper._ba_done``),
never inside a capture; the pose write-back runs after the graph.
"""
from __future__ import annotations

import contextlib
import gc
from typing import Dict, List, Optional, Sequence

import torch

from naruto_tpu_torch.ops import kernels
from naruto_tpu_torch.utils.timer import SPANS, span, stage

# the stream every mapper's warm-ups and captures run on, one per device:
# the look-back state and the library workspaces of a stream are made at
# its first use and kept, so the process makes them once
_CAPTURE_STREAMS: Dict[int, torch.cuda.Stream] = {}


# per cur_cap bucket: BA calls, graph replays, captures and warm-up runs
GRAPH_COUNTS: Dict[int, Dict[str, int]] = {}


def _count(bucket: int, what: str) -> None:
    GRAPH_COUNTS.setdefault(bucket, dict.fromkeys(
        ("calls", "replays", "captures", "warm_ups"), 0))[what] += 1


def reset_graph_counts() -> None:
    GRAPH_COUNTS.clear()


def graph_counts() -> Dict[int, Dict[str, int]]:
    return {b: dict(c) for b, c in GRAPH_COUNTS.items()}


def capture_stream(device: torch.device) -> torch.cuda.Stream:
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    if index not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[index] = torch.cuda.Stream(index)
    return _CAPTURE_STREAMS[index]


class _Program:
    """One bucket's BA call: its draws, its graph, its outputs; the other
    static inputs are the BAGraphs' (every bucket's the same)."""

    def __init__(self, mapper, setup, draws: Sequence):
        from naruto_tpu_torch.mapping.mapper import BADraws

        self.mapper = mapper
        self.setup = setup
        self.draws = BADraws(*(
            None if f is None else f.new_empty((len(draws), *f.shape))
            for f in draws[0]))
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.failed: Optional[str] = None
        # kernel launches of each captured iteration
        self.launches_per_iter: List[Dict[str, int]] = []
        # the (stage, CUDA event) marks the graph records
        self.stages: List = []
        self._keys: List[List[str]] = []
        self._flat: Optional[torch.Tensor] = None

    def load(self, draws: Sequence) -> None:
        """Copy a call's draws into the static buffers."""
        for buf, *parts in zip(self.draws, *draws):
            if buf is not None:
                torch.stack(parts, out=buf)

    def run(self, mark=None) -> List[Dict]:
        """The call on the static inputs, as the graph holds it; `mark()`
        after each iteration (the capture's launch tally)."""
        from naruto_tpu_torch.mapping.mapper import BADraws

        m, st = self.mapper, self.setup
        stage("start")
        if st.pose is not None:
            st.pose.begin(m.poses, st.c2w, st.kf_count)
        auxes = []
        for it in range(m.cfg.mapper.iters):
            d = BADraws(*(None if f is None else f[it] for f in self.draws))
            auxes.append(m._ba_iteration(st, d, it)[0])
            if mark is not None:
                mark()
        return auxes

    def capture(self, pool, stream: torch.cuda.Stream) -> None:
        graph = torch.cuda.CUDAGraph()
        marks: List[Dict[str, int]] = []
        with span("ba.wait"):
            torch.cuda.synchronize()      # torch.cuda.graph's own wait
        try:
            with kernels.capturing() as tally, \
                    SPANS.stage_events() as stages, _no_gc():
                # thread_local: the frame prefetcher's thread may copy and
                # allocate pinned memory meanwhile
                with torch.cuda.graph(graph, pool=pool, stream=stream,
                                      capture_error_mode="thread_local"):
                    outs = self.run(lambda: marks.append(dict(tally)))
                    self._keys = [list(a) for a in outs]
                    self._flat = torch.stack(
                        [v for a in outs for v in a.values()])
        except BaseException as exc:
            self.failed = f"{type(exc).__name__}: {exc}"
            raise
        torch.cuda.current_stream().wait_stream(stream)
        before = dict.fromkeys(kernels.LAUNCHES, 0)
        for mark in marks:
            self.launches_per_iter.append(
                {k: mark[k] - before[k] for k in mark})
            before = mark
        self.stages = stages
        self.graph = graph

    def replay(self) -> List[Dict]:
        with span("ba.launch"):
            self.graph.replay()
            for counts in self.launches_per_iter:
                kernels.add_launches(counts)
            SPANS.replayed = self.stages
        with span("ba.outputs"):
            values = self._flat.clone()
            out, i = [], 0
            for keys in self._keys:
                out.append({k: values[i + j] for j, k in enumerate(keys)})
                i += len(keys)
        return out


@contextlib.contextmanager
def _no_gc():
    """No cyclic garbage collection inside: a collection could destroy a
    dead mapper's CUDA graph, which a capture under way refuses (the
    capture then fails)."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


class BAGraphs:
    """A mapper's BA calls as captured programs, one per cur_cap bucket;
    call it as Mapper._ba_impl. The first call makes the pool, takes the
    device's capture stream and warms every bucket's program up; each
    bucket's program is captured at the bucket's first call, and every
    call, the first included, is one replay. ``load``, ``warm_up`` and
    ``_Program.run`` also serve the tests on the CPU, uncaptured."""

    def __init__(self, mapper):
        self.mapper = mapper
        self.programs: Dict[int, _Program] = {}
        self.inputs = None    # the static BASetup every program reads
        self.pool = None
        self.stream: Optional[torch.cuda.Stream] = None
        self.warming = False  # in the warm-up (uncaptured iterations)

    def load(self, cur_cap: int, frame_rays, c2w, frame_id: int,
             draws: Optional[Sequence] = None) -> tuple:
        """A call's inputs (the generators' draws unless `draws`) in the
        static buffers, the bucket's program made at its first load ->
        (program, setup)."""
        from naruto_tpu_torch.mapping.mapper import BASetup

        m = self.mapper
        setup = m._ba_inputs(cur_cap, frame_rays, c2w, frame_id)
        if draws is None:
            with span("ba.draws"):
                draws = [m._draw_ba(setup)
                         for _ in range(m.cfg.mapper.iters)]
        with span("ba.load"):
            if self.inputs is None:
                dev = m.device
                self.inputs = BASetup(
                    0, torch.empty_like(setup.frame_rays),
                    torch.empty_like(setup.c2w),
                    torch.empty_like(setup.valid_order), 0,
                    torch.zeros((), dtype=torch.int64, device=dev),
                    torch.empty_like(setup.scalars),
                    torch.zeros((), dtype=torch.int64, device=dev),
                    setup.pose)
            st = self.inputs
            st.frame_rays.copy_(setup.frame_rays)
            st.c2w.copy_(setup.c2w)
            st.valid_order.copy_(setup.valid_order)
            st.num_cur.fill_(setup.num_cur)
            st.kf_count.fill_(setup.kf_count)
            st.scalars.copy_(setup.scalars)
            prog = self.programs.get(cur_cap)
            if prog is None:
                prog = self.programs[cur_cap] = _Program(
                    m, st._replace(cur_cap=cur_cap), draws)
            prog.load(draws)
        return prog, setup

    def warm_up(self, frame_rays, c2w, frame_id: int) -> None:
        """Every bucket's program run once, uncaptured, on the capture
        stream, before any capture: it builds the kernels, sizes their
        look-back state for every bucket's shapes, makes the library
        workspaces of the stream and fills the device-constant cache, so
        that no capture needs to. Its draws come from generators of their
        own, and the state it steps (the field, the optimizer moments, the
        uncertainty gradient sum) is put back: the run's state, counts and
        generators are as before.

        Memory: the state is kept on the host meanwhile, and every bucket's
        static buffers are made before the first run, so that no buffer
        that lives on is carved from a block the runs' temporaries leave:
        the caching allocator can give all of those back before the first
        capture fills the graphs' pool (torch.cuda.graph empties the
        cache)."""
        from naruto_tpu_torch.mapping.mapper import CUR_BUCKETS
        from naruto_tpu_torch.utils.seeding import make_generators

        m = self.mapper
        state = m._ba_state()
        with span("ba.wait"):
            saved = [t.detach().to("cpu", copy=True) for t in state]
        gens, m.gens = m.gens, make_generators(0, m.device)
        self.warming = True
        try:
            buckets = sorted(CUR_BUCKETS, reverse=True)
            progs = [self.load(b, frame_rays, c2w, frame_id)[0]
                     for b in buckets]
            for b, prog in zip(buckets, progs):
                _count(b, "warm_ups")
                if self.stream is None:       # the CPU (the tests)
                    prog.run()
                else:
                    self.stream.wait_stream(torch.cuda.current_stream())
                    with torch.cuda.stream(self.stream):
                        prog.run()
                    torch.cuda.current_stream().wait_stream(self.stream)
        finally:
            self.warming = False
            m.gens = gens
            with torch.no_grad(), span("ba.wait"):
                for t, v in zip(state, saved):
                    t.copy_(v)

    def __call__(self, cur_cap: int, frame_rays, c2w, frame_id: int,
                 draws: Optional[Sequence] = None) -> List[Dict]:
        m = self.mapper
        with span("ba.call", cur_cap, call=True):
            _count(cur_cap, "calls")
            if not self.programs:
                self.pool = torch.cuda.graph_pool_handle()
                self.stream = capture_stream(m.device)
                with span("ba.warm_up"):
                    self.warm_up(frame_rays, c2w, frame_id)
            prog = self.programs.get(cur_cap)
            if prog is None:
                raise ValueError(f"cur_cap {cur_cap} is no bucket of "
                                 f"{sorted(self.programs)}")
            if prog.failed:
                raise RuntimeError(f"the BA graph of bucket {cur_cap} failed "
                                   f"to capture ({prog.failed}); its calls "
                                   f"do not run eagerly")
            if prog.graph is None:
                # before the call's draws: a capture that fails leaves the
                # generators, as everything else, as they were
                with span("ba.capture"):
                    _count(cur_cap, "captures")
                    prog.capture(self.pool, self.stream)
            prog, setup = self.load(cur_cap, frame_rays, c2w, frame_id,
                                    draws)
            auxes = self.replay(prog)
            with span("ba.done"):
                m._ba_done(setup, frame_id)
            return auxes

    def replay(self, prog: _Program) -> List[Dict]:
        """One graph launch: the call on the inputs loaded."""
        _count(prog.setup.cur_cap, "replays")
        return prog.replay()
