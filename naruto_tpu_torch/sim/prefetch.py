"""Frame prefetch for passive mapping (counterpart of
naruto_tpu/sim/prefetch.py).

In passive mode (a predefined trajectory) the next frame's pose is known, so
a worker thread renders the next CONSUMED frame while the mapper trains on
the current one. Frames nothing consumes (needs_fn(step) False: no mapping,
keyframe or rgbd artifact) are never rendered. When a needs_fn is supplied
(no visualizer wants raw float rgbd), float colour is quantized to uint8 as
the JAX package quantizes it for its host-to-device hop; the mapper's
frame_to_rays dequantizes it. Here the frame never leaves the sim's device:
the quantization keeps the two packages' frames equal.

The worker renders on the device's default stream, which every host thread
shares, so a frame's kernels are ordered before any kernel the main thread
enqueues after it has taken the frame. Worker-thread sim stepping is safe:
simulate() is pure and update_step only sets the step (the analytic sim's
dynamic-object phase).
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Tuple

import numpy as np
import torch


class FramePrefetcher:
    def __init__(self, sim, pose_fn: Callable[[int], np.ndarray],
                 needs_fn: Optional[Callable[[int], bool]] = None,
                 horizon: Optional[int] = None):
        """pose_fn(step) -> c2w for passive trajectories.
        needs_fn(step) -> whether anything consumes the frame; None means
        every frame is consumed (a visualizer saves raw rgbd).
        horizon: number of steps in the run; no prefetch is issued at or
        past it (pose_fn would be out of range)."""
        self.sim = sim
        self.pose_fn = pose_fn
        self.needs = needs_fn
        self.horizon = horizon
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._next = None
        self._next_step = -1

    def _load(self, step: int):
        self.sim.update_step(step)
        color, depth = self.sim.simulate(self.pose_fn(step))[:2]
        if self.needs is not None and color.dtype != torch.uint8:
            color = (torch.clamp(color, 0.0, 1.0) * 255.0 + 0.5).to(
                torch.uint8)
        return color, depth

    def _next_needed(self, step: int) -> int:
        if self.needs is None:
            return step
        while not self.needs(step):
            step += 1
        return step

    def get(self, step: int) -> Tuple:
        if self.needs is not None and not self.needs(step):
            # no consumer: the pipeline already points at the next needed
            # step (submitted when that frame's predecessor was consumed)
            return None, None
        if self._next is not None and self._next_step == step:
            color, depth = self._next.result()
        else:
            color, depth = self._load(step)
        nxt = self._next_needed(step + 1)
        if self.horizon is None or nxt < self.horizon:
            self._next = self._pool.submit(self._load, nxt)
            self._next_step = nxt
        return color, depth

    def close(self):
        """Wait for the frame in flight and stop the worker."""
        self._pool.shutdown(wait=True)
