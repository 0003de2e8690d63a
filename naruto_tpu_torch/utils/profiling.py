"""Device profiling hooks (counterpart of naruto_tpu/utils/profiling.py).

The reference only has the wall-clock Timer (SURVEY.md §5.1); the JAX
package adds ``jax.profiler`` trace capture, and the port the same through
``torch.profiler``: a Chrome trace of the enclosed block (host operators,
and the card's kernels where CUDA is available) written into ``log_dir``.
The program's spans (utils/timer.py) land in it as ``user_annotation``
events, on the clock of the kernels.
"""
from __future__ import annotations

import os
from contextlib import contextmanager

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
