"""Wall-clock stage timer with grouped median/mean breakdown (the port's
own copy of naruto_tpu/utils/timer.py).

Behavioral parity with the reference Timer (src/utils/timer.py:30-135): named
start/end accumulators organised in groups, a summary printed at run end with
median and mean per item, plus a context-manager API. Sections time the
host: a section around asynchronous device work ends when the work is
enqueued, not when it is done.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, List


class Timer:
    def __init__(self) -> None:
        self._starts: Dict[str, float] = {}
        self.timings: Dict[str, List[float]] = {}
        self.groups: Dict[str, str] = {}

    def start(self, name: str, group: str = "General") -> None:
        self._starts[name] = time.perf_counter()
        if name not in self.timings:
            self.timings[name] = []
            self.groups[name] = group

    def end(self, name: str) -> float:
        dt = time.perf_counter() - self._starts.pop(name)
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

    def total(self, name: str) -> float:
        return sum(self.timings.get(name, []))

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
