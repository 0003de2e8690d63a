"""Device time by kernel in a torch.profiler chrome trace, such as the
one-BA-step trace ``chip_smoke.py --profile DIR`` writes to
``DIR/ba_step_trace.json``.

Run:  python -m naruto_tpu_torch.scripts.trace_summary TRACE.json
          [--iters N] [--top K]

Each kernel the card ran is keyed by the operator that launched it (the
innermost CPU operator with the kernel's external id; "-" for kernels
launched outside one, as the port's ctypes wrappers are) and its name
without template arguments and parameters; the port's own kernels (in an
anonymous namespace) are also keyed by their grid, so one kernel at two
shapes shows as two rows. Per key: launches, total device us and us per
iteration (the trace spans --iters iterations; 10 for one BA step), the K
largest first, then the totals. Reads the trace only; runs anywhere.

device_ms() takes such a trace of a function's calls and gives its device
time; it needs the card, and is what chip_smoke.py and the probes time by.
"""
from __future__ import annotations

import argparse
import collections
import json
import re
import sys
import time


# the kernel of an int8 fill, which no path of the port launches
LEAD_KERNEL = "FillFunctor<signed char>"


def lead_launch(lead) -> None:
    """The first launch of a traced session: an int8 fill of `lead`, then a
    synchronize. In a process that has run the mapper, the tracer loses
    the first kernel of every session (seen on an H100 with torch 2.x: the
    launch call is recorded, its kernel is not), so this one goes first
    and is left out of the count by its name, LEAD_KERNEL."""
    import torch

    lead.fill_(0)
    torch.cuda.synchronize()


def device_ms(fn, reps: int = 10, tries: int = 5) -> float:
    """Device time of one fn() in milliseconds (device_profile's)."""
    return device_profile(fn, reps, tries)[0]


def device_profile(fn, reps: int = 10, tries: int = 5) -> tuple:
    """(device ms, launches) of one fn(): the kernels and copies that
    torch.profiler traces over `reps` calls, their time summed and counted,
    over reps. Unlike the CUDA-event time it leaves out the device's wait
    on the host's enqueue. The tracer drops records now and then, whole
    traces too, and for several traces on end: a trace in which some
    kernel does not show a multiple of `reps` times is taken again half a
    second later, and after `tries` such traces this gives (NaN, NaN), with
    a line on stderr. No number comes from a trace that lost records."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    lead = torch.empty(1, dtype=torch.int8, device="cuda")
    torch.cuda.synchronize()
    seen = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            lead_launch(lead)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        on_device = [e for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and not e.is_user_annotation
                     and LEAD_KERNEL not in e.key]
        if on_device and all(e.count % reps == 0 for e in on_device):
            return (sum(e.self_device_time_total for e in on_device)
                    / 1e3 / reps, sum(e.count for e in on_device) / reps)
        seen.append([(e.key, e.count) for e in on_device])
        time.sleep(0.5)
    print(f"device_profile: the profiler lost records in {tries} traces of "
          f"{reps} calls, no device time: {seen}", file=sys.stderr, flush=True)
    return float("nan"), float("nan")


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


def summarize(events: list) -> dict:
    """(operator, kernel[, grid]) -> [launches, total us]."""
    ops = {}
    for e in events:
        if e.get("cat") == "cpu_op":
            ext = e.get("args", {}).get("External id")
            # the innermost operator: the one that started last
            if ext is not None and (ext not in ops or e["ts"] > ops[ext][0]):
                ops[ext] = (e["ts"], e["name"])
    table = collections.defaultdict(lambda: [0, 0.0])
    for e in events:
        if e.get("cat") != "kernel":
            continue
        args = e.get("args", {})
        op = ops.get(args.get("External id"), (0, "-"))[1]
        key = (op, short_name(e["name"]))
        if re.match(r"(void )?\(anonymous namespace\)::", e["name"]):
            key += (tuple(args.get("grid", ())),)
        table[key][0] += 1
        table[key][1] += e["dur"]
    return table


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace")
    ap.add_argument("--iters", type=int, default=10,
                    help="iterations the trace spans (default 10: one BA "
                         "step)")
    ap.add_argument("--top", type=int, default=40)
    args = ap.parse_args(argv)
    with open(args.trace) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    table = summarize(events)
    rows = sorted(table.items(), key=lambda kv: -kv[1][1])
    print(f"{'operator':28s} {'kernel':40s} {'grid':14s} {'launches':>8s} "
          f"{'us':>10s} {'us/iter':>9s}")
    for key, (n, us) in rows[:args.top]:
        grid = "x".join(map(str, key[2])) if len(key) > 2 else ""
        print(f"{key[0][:28]:28s} {key[1][:40]:40s} {grid:14s} {n:8d} "
              f"{us:10.1f} {us / args.iters:9.2f}")
    launches = sum(n for n, _ in table.values())
    total = sum(us for _, us in table.values())
    print(f"kernels: {launches} launches, {total:.1f} us "
          f"({launches / args.iters:.1f} launches and "
          f"{total / args.iters:.1f} us an iteration)")


if __name__ == "__main__":
    main()
