"""The traced segment of a ``--trace 1`` run: torch.profiler over a fixed
number of the cell's work units, exported as a chrome trace and read back.

From the trace: the device's busy seconds (the union of its kernels,
copies and fills) inside the segment's window (the ``bench.segment``
annotation), each kernel's launches and seconds, and the idle gaps
between device work, each named by the innermost host event that spans
the gap's middle (what the host was doing meanwhile).
"""
from __future__ import annotations

import collections
import json
import os
import re
from typing import Callable, Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "user_annotation")
SEGMENT = "bench.segment"
# a kernel no path of the program launches (an int8 fill): the tracer can
# lose the first kernel of a trace, so this one goes first
LEAD_KERNEL = "FillFunctor<signed char>"


def short_name(name: str) -> str:
    """'void ns::kernel<...>(args)' -> 'kernel'."""
    name = re.sub(r"^void ", "", name)
    depth, out = 0, []
    for ch in name:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return "".join(out).split("::")[-1].strip() or name


def record(units: Callable[[], None], path: str) -> dict:
    """Trace `units()` (the segment's work, ending in a synchronize) and
    read the trace written to `path`."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    lead = torch.empty(1, dtype=torch.int8, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        lead.fill_(0)
        torch.cuda.synchronize()
        with record_function(SEGMENT):
            units()
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    os.remove(path)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return summarize(events)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def summarize(events: List[dict]) -> dict:
    """{"window_s", "busy_s", "kernels": {full name: [launches, s]},
    "idle_gaps": {host event: s}} of the segment; window_s 0 when the
    trace has no segment."""
    seg = [e for e in events if e.get("name") == SEGMENT
           and e.get("cat") == "user_annotation"]
    if not seg:
        return {"window_s": 0.0, "busy_s": 0.0, "kernels": {},
                "idle_gaps": {}}
    lo = float(seg[0]["ts"])
    hi = lo + float(seg[0]["dur"])
    dev, host = [], []
    kernels: Dict[str, List[float]] = collections.defaultdict(
        lambda: [0, 0.0])
    for e in events:
        if "ts" not in e or "dur" not in e:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if e.get("cat") in DEVICE_CATS:
            if b <= lo or a >= hi or LEAD_KERNEL in e.get("name", ""):
                continue
            dev.append((max(a, lo), min(b, hi)))
            k = kernels[e.get("name", "?")]
            k[0] += 1
            k[1] += (b - a) * 1e-6
        elif e.get("cat") in HOST_CATS and e.get("name") != SEGMENT:
            host.append((a, b, e.get("name", "?")))
    busy = _union(dev)
    gaps = collections.defaultdict(float)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        spans = [(y - x, n) for x, y, n in host if x <= mid <= y]
        gaps[min(spans)[1] if spans else "-"] += (b - a) * 1e-6
    return {"window_s": (hi - lo) * 1e-6,
            "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "kernels": dict(kernels), "idle_gaps": dict(gaps)}


def breakdown(summary: dict, top: int = 10) -> dict:
    """The device operations that took most time and the longest idle
    gaps by host event, each list at most `top` long."""
    ops = collections.defaultdict(float)
    for name, (_, s) in summary["kernels"].items():
        ops[short_name(name)] += s
    return {"device_ops": [[k, v] for k, v in sorted(
                ops.items(), key=lambda kv: -kv[1])[:top]],
            "idle_gaps": [[k, v] for k, v in sorted(
                summary["idle_gaps"].items(), key=lambda kv: -kv[1])[:top]]}


def kernel_time(summary: dict, pattern: str) -> Optional[Tuple[int, float]]:
    """(launches, seconds) of the kernel whose full name contains
    `pattern`, the instantiation with the most device time where several
    do; None where the trace has none."""
    rows = [v for k, v in summary["kernels"].items() if pattern in k]
    if not rows:
        return None
    n, s = max(rows, key=lambda v: v[1])
    return int(n), float(s)
