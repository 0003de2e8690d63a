"""A BA iteration's least time on the chip (work.py: the larger of its
FLOPs at the float32 peak and its bytes at the HBM peak) over its
measured device time (the median call's CUDA-event time over the
iterations a call), %."""
import statistics

import work


def read(run):
    if run.kind != "map" or not run.unit_device_ms:
        return None
    least, _ = work.least_seconds(*work.ba_iteration_work(run.cfg,
                                                          run.bucket))
    measured = statistics.median(run.unit_device_ms) * 1e-3 / run.iters
    return 100.0 * least / measured
