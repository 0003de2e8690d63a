"""Host spans, the wall-clock stage timer built on them (the port's own copy
of naruto_tpu/utils/timer.py), and the device-time stages of a captured BA
call.

Spans. ``span(name)`` times a section of the host into one process-level
store (``SPANS``), a ring of the last ``CAPACITY`` records. A record holds
the name, the start and end (``time.perf_counter_ns``), the span that
caused it (the innermost span open on the same thread) and the call it
belongs to: the id of the innermost enclosing span opened with
``call=True``, so every span of one BA call shares its ``ba.call``'s id.
With no profiler recording a span costs two clock reads and a record and
calls nothing of torch (the profiler's flag is a plain module attribute);
while one records, each span also enters
``torch.profiler.record_function(name)``, so that it lands in the trace as
a ``user_annotation`` on the clock of the card's kernels.

Device spans. ``SPANS.timed(name, device)`` is a span that, on a card,
also records a CUDA timing event pair on the current stream around what
it enqueues (the map-volume query's ``volumes.query``); the store keeps
the last ``DEVICE_CAPACITY`` pairs and reads them only on request
(``SPANS.device_ms(name)``, which synchronizes).

Timer. Behavioral parity with the reference Timer (src/utils/timer.py:30-135):
named start/end accumulators organised in groups, a summary printed at run
end with median and mean per item, plus a context-manager API. Each section
is a span. Sections time the host: a section around asynchronous device
work ends when the work is enqueued, not when it is done.

Stages. While a BA graph captures (``SPANS.stage_events()``),
``stage(name)`` records a CUDA timing event on the current stream, which
the graph holds as an event node and records at every replay: a stage runs
from the mark before it to its own. The store keeps the marks of the
program replayed last (``SPANS.replayed``) and reads them only on request
(``SPANS.stage_ms()``, after a synchronize). Outside a capture ``stage``
does nothing.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager
from itertools import count
from typing import Dict, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler

# records the store keeps: the spans of ~8,000 BA calls, 8 a call
CAPACITY = 1 << 16
# CUDA event pairs of device spans the store keeps (one a mapping step)
DEVICE_CAPACITY = 1 << 12


class Span(NamedTuple):
    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: int             # the id of the span that caused it; -1: none
    call: int               # the id of the call it belongs to; -1: none
    arg: Optional[int]      # what it carries (a ba.call's bucket)


class _Open:
    """A span under way; a context manager that closes it."""

    __slots__ = ("store", "id", "name", "arg", "parent", "call", "start_ns",
                 "annotation")

    def __enter__(self) -> "_Open":
        return self

    def __exit__(self, *exc) -> None:
        self.store.close(self)


class SpanStore:
    """The last `capacity` spans of the process, each thread's open spans,
    the event pairs of the device spans and the stage marks of the BA
    graphs."""

    def __init__(self, capacity: int = CAPACITY):
        self._ring: deque = deque(maxlen=capacity)
        # (span id, name, start event, end event) of the device spans
        self._device: deque = deque(maxlen=DEVICE_CAPACITY)
        self._ids = count()
        self._local = threading.local()
        self._stages: Optional[list] = None
        # (stage, CUDA event) marks of the program replayed last
        self.replayed: Optional[list] = None

    def open(self, name: str, arg: Optional[int] = None,
             call: bool = False) -> _Open:
        """Open a span (close it with close(), or use it in a with)."""
        try:
            stack = self._local.stack
        except AttributeError:
            stack = self._local.stack = []
        top = stack[-1] if stack else None
        s = _Open()
        s.store, s.name, s.arg = self, name, arg
        s.id = next(self._ids)
        s.parent = top.id if top is not None else -1
        s.call = s.id if call else (top.call if top is not None else -1)
        s.annotation = None
        if _profiler._is_profiler_enabled:
            s.annotation = _profiler.record_function(name)
            s.annotation.__enter__()
        stack.append(s)
        s.start_ns = time.perf_counter_ns()
        return s

    def close(self, s: _Open) -> int:
        """Record the span -> its nanoseconds."""
        end = time.perf_counter_ns()
        if s.annotation is not None:
            s.annotation.__exit__(None, None, None)
        stack = getattr(self._local, "stack", [])
        if stack and stack[-1] is s:
            stack.pop()
        elif s in stack:
            stack.remove(s)
        self._ring.append(Span(s.id, s.name, s.start_ns, end, s.parent,
                               s.call, s.arg))
        return end - s.start_ns

    def records(self) -> List[Span]:
        """The spans kept, in the order they ended."""
        return list(self._ring)

    @contextmanager
    def timed(self, name: str, device: torch.device):
        """A span; on a card also a CUDA event pair on the current stream
        around the work it enqueues, kept for device_ms()."""
        with self.open(name) as s:
            if device.type != "cuda":
                yield
                return
            e0 = torch.cuda.Event(enable_timing=True)
            e0.record()
            yield
            e1 = torch.cuda.Event(enable_timing=True)
            e1.record()
            self._device.append((s.id, name, e0, e1))

    def device_ms(self, name: str) -> List[float]:
        """The device ms of each kept device span named `name`, in the
        order they were opened."""
        pairs = [(a, b) for _, n, a, b in self._device if n == name]
        if pairs:
            torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in pairs]

    @contextmanager
    def stage_events(self):
        """Within: stage() records its marks into the list yielded."""
        self._stages = marks = []
        try:
            yield marks
        finally:
            self._stages = None

    def stage(self, name: str) -> None:
        marks = self._stages
        if marks is not None:
            e = torch.cuda.Event(enable_timing=True, external=True)
            e.record()
            marks.append((name, e))

    def stage_ms(self) -> Optional[Dict[str, float]]:
        """Each stage's device ms in the program replayed last, summed over
        its iterations; None where none with marks has replayed."""
        marks = self.replayed
        if not marks:
            return None
        torch.cuda.synchronize()
        out: Dict[str, float] = {}
        for (_, a), (name, b) in zip(marks, marks[1:]):
            out[name] = out.get(name, 0.0) + a.elapsed_time(b)
        return out


SPANS = SpanStore()
span = SPANS.open
stage = SPANS.stage


class Timer:
    def __init__(self) -> None:
        self._open: Dict[str, _Open] = {}
        self.timings: Dict[str, List[float]] = {}
        self.groups: Dict[str, str] = {}

    def start(self, name: str, group: str = "General") -> None:
        self._open[name] = span(name)
        if name not in self.timings:
            self.timings[name] = []
            self.groups[name] = group

    def end(self, name: str) -> float:
        dt = SPANS.close(self._open.pop(name)) * 1e-9
        self.timings[name].append(dt)
        return dt

    @contextmanager
    def time(self, name: str, group: str = "General"):
        self.start(name, group)
        try:
            yield
        finally:
            self.end(name)

    def get_last_timing(self, name: str) -> float:
        return self.timings[name][-1]

    def summary(self) -> str:
        import numpy as np

        lines = ["=" * 60, "Timing analysis (seconds)", "=" * 60]
        by_group: Dict[str, List[str]] = {}
        for name, vals in self.timings.items():
            if not vals:
                continue
            arr = np.asarray(vals)
            row = (
                f"  {name:<28s} n={len(vals):<6d} "
                f"median={np.median(arr):.4f} mean={arr.mean():.4f} "
                f"total={arr.sum():.2f}"
            )
            by_group.setdefault(self.groups.get(name, "General"), []).append(row)
        for group, rows in by_group.items():
            lines.append(f"[{group}]")
            lines.extend(rows)
        lines.append("=" * 60)
        return "\n".join(lines)

    def time_analysis(self) -> None:
        print(self.summary())
