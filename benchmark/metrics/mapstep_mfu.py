"""A mapping step's least time on the chip over its measured device time
(the median step's CUDA-event time), %. The least time is that of the
step's FLOPs and bytes together (work.least_seconds): ``iters`` BA
iterations (work.py) and one map-volume query (volume_work.py); the SDF's
host copy counts nothing."""
import statistics

import volume_work
import work


def read(run):
    if run.kind != "mapstep" or not run.unit_device_ms:
        return None
    flops, nbytes = work.ba_iteration_work(run.cfg, run.bucket)
    q_flops, q_bytes = volume_work.volume_query_work(run.cfg)
    least, _ = work.least_seconds(run.iters * flops + q_flops,
                                  run.iters * nbytes + q_bytes)
    measured = statistics.median(run.unit_device_ms) * 1e-3
    return 100.0 * least / measured
