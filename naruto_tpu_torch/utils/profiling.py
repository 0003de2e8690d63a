"""Device profiling hooks (counterpart of naruto_tpu/utils/profiling.py).

The reference only has the wall-clock Timer (SURVEY.md §5.1); the JAX
package adds ``jax.profiler`` trace capture, and the port the same through
``torch.profiler``: a Chrome trace of the enclosed block (host operators,
and the card's kernels where CUDA is available) written into ``log_dir``,
plus a helper that times a call with the device synchronised.
"""
from __future__ import annotations

import os
import time
from contextlib import contextmanager
from typing import Callable

import torch


@contextmanager
def device_trace(log_dir: str):
    """Capture a torch.profiler trace of the enclosed block into
    ``log_dir/trace.json`` (Chrome trace format)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=acts)
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _synchronize(out) -> None:
    """Wait for the devices of every tensor in `out` (nested lists, tuples
    and dicts)."""
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _synchronize(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            _synchronize(v)


def time_call(fn: Callable, *args, warmup: int = 1, iters: int = 10,
              **kw) -> float:
    """Median seconds per call of fn, each call waited for on the devices
    of its outputs (time_jitted's counterpart)."""
    for _ in range(warmup):
        _synchronize(fn(*args, **kw))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _synchronize(fn(*args, **kw))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]
