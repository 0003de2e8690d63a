"""What the program's own tracing recorded (naruto_tpu_torch/utils/timer.py
``SPANS``): the BA calls' host spans and the device time of the stages
inside the BA graph replayed last. Read after the run; every function
gives None where the program keeps no such store (a program without span
tracing) or the store holds nothing (the CPU, the eager BA)."""
from __future__ import annotations

from typing import Dict, List, Optional


def store():
    """The program's span store, or None."""
    from naruto_tpu_torch.utils import timer

    return getattr(timer, "SPANS", None)


def window_calls(run) -> Optional[List[List]]:
    """The spans of each of the window's BA calls: the store's last
    len(run.unit_s) + trace_units ``ba.call`` spans, less the traced
    segment's last trace_units; each call's own spans, the ``ba.call``
    last. None where the store does not hold them all."""
    s = store()
    if s is None or run.kind != "map" or not run.unit_s:
        return None
    records = s.records()
    calls = [r for r in records if r.name == "ba.call"]
    n, traced = len(run.unit_s), run.traffic.get("trace_units", 0)
    if len(calls) < n + traced:
        return None
    window = calls[len(calls) - n - traced:len(calls) - traced]
    own: Dict[int, List] = {c.id: [] for c in window}
    for r in records:
        if r.call in own:
            own[r.call].append(r)
    return [own[c.id] for c in window]


def stage_ms(run, stage: str) -> Optional[float]:
    """Device ms a BA iteration spends in `stage`, in the last replay."""
    s = store()
    if s is None or run.kind != "map":
        return None
    ms = s.stage_ms()
    if not ms or stage not in ms:
        return None
    return ms[stage] / run.iters
