"""What the program's tracing recorded of each mapping step of a
``mapstep`` run (naruto_tpu_torch/utils/timer.py ``SPANS``): the map-volume
query's device time (the ``volumes.query`` span's CUDA event pair) and the
SDF volume's host copy (the ``volumes.host`` spans of volume 1). Read
after the run; every function gives None where the program keeps no such
record (a program without these spans) or holds too few of them."""
from __future__ import annotations

from typing import List, Optional

import program_spans


def window(run, per_step: List[float]) -> Optional[List[float]]:
    """The window's entries of `per_step` (one a mapping step, in the
    order the steps ran: set-up's, the window's, then the traced
    segment's): the last len(run.unit_s) before the traced segment's."""
    if run.kind != "mapstep" or not run.unit_s:
        return None
    n = len(run.unit_s)
    traced = run.traffic.get("trace_units", 0) if run.trace is not None \
        else 0
    if len(per_step) < n + traced:
        return None
    return per_step[len(per_step) - n - traced:len(per_step) - traced]


def query_ms(run) -> Optional[List[float]]:
    """Device ms of each of the window's map-volume queries."""
    s = program_spans.store()
    if s is None or not hasattr(s, "device_ms"):
        return None
    return window(run, s.device_ms("volumes.query"))


def host_ms(run) -> Optional[List[float]]:
    """Host ms of each of the window's SDF host copies."""
    s = program_spans.store()
    if s is None:
        return None
    return window(run, [(r.end_ns - r.start_ns) * 1e-6 for r in s.records()
                        if r.name == "volumes.host" and r.arg == 1])
