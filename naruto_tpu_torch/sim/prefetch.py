"""Frame prefetch for passive runs over host frame sources (counterpart of
naruto_tpu/sim/prefetch.py).

In a passive run the next frame's pose is known, so one worker thread makes
the next CONSUMED frame while the mapper trains on the current one. The
order is the JAX module's:
  * ``get(step)`` returns (None, None) for a step nothing consumes
    (``needs_fn(step)`` False: no mapping, keyframe, tracking or rgbd
    artifact); such frames are never made;
  * one frame is in flight, that of the next needed step, and none at or
    past ``horizon``;
  * a step asked for out of order is loaded on the calling thread (after
    the frame in flight, which is dropped: one thread steps the simulator
    at a time);
  * with ``needs_fn=None`` every frame is made and its colour stays float
    (the artifact saver wants it); otherwise it is uint8.

The simulator must make its frames on the host (``host_frame``: the
raycast and replay simulators). The worker does host work only: it steps
the simulator (``update_step``; the engine does not step it while a
prefetcher runs), calls ``host_frame``, and on the card writes the arrays
into one of two pinned host buffers per array and issues their copy to
the device with ``non_blocking=True`` on the prefetcher's own stream,
recording an event after it. A pinned buffer is rewritten only once the
event of its last copy has completed. ``get`` on the consumer's thread
makes the consumer's current stream wait for that event (a device-side
wait) and records that stream on the delivered tensors, so the caching
allocator keeps their memory until the consumer's reads are done. On the
CPU there is no stream and no pinning: the frame is the host arrays.

An exception in the worker re-raises from ``get``. ``close`` waits for
the frame in flight (its buffers and stream must outlive the copy).
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor, wait
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
        self.device = torch.device(sim.device)
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._next = None
        self._next_step = -1
        self._stream = None
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            self._pinned = [None, None]    # per slot: pinned colour, depth
            self._copied = [None, None]    # per slot: its last copy's event
            self._slot = 0

    def _load(self, step: int):
        self.sim.update_step(step)
        color, depth = self.sim.host_frame(self.pose_fn(step),
                                           quantize=self.needs is not None)
        if self._stream is None:
            return torch.from_numpy(color), torch.from_numpy(depth), None
        return self._upload(color, depth)

    def _fill(self, slot: int, arrays) -> list:
        """The slot's pinned buffers holding `arrays` (allocated on the
        first frame)."""
        bufs = self._pinned[slot]
        if bufs is None:
            bufs = self._pinned[slot] = [
                torch.empty(a.shape, dtype=torch.from_numpy(a).dtype,
                            pin_memory=True) for a in arrays]
        for b, a in zip(bufs, arrays):
            b.copy_(torch.from_numpy(a))
        return bufs

    def _upload(self, *arrays):
        slot, self._slot = self._slot, 1 - self._slot
        if self._copied[slot] is not None:
            self._copied[slot].synchronize()
        host = self._fill(slot, arrays)
        with torch.cuda.stream(self._stream):
            out = [torch.empty(h.shape, dtype=h.dtype, device=self.device)
                   .copy_(h, non_blocking=True) for h in host]
            done = torch.cuda.Event()
            done.record(self._stream)
        self._copied[slot] = done
        return (*out, done)

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
            color, depth, done = self._next.result()
        else:
            if self._next is not None:
                wait([self._next])
            color, depth, done = self._load(step)
        nxt = self._next_needed(step + 1)
        if self.horizon is None or nxt < self.horizon:
            self._next = self._pool.submit(self._load, nxt)
            self._next_step = nxt
        if done is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(done)
            color.record_stream(stream)
            depth.record_stream(stream)
        return color, depth

    def close(self):
        """Wait for the frame in flight and its copy, and stop the
        worker."""
        self._pool.shutdown(wait=True)
        if self._stream is not None:
            self._stream.synchronize()
