"""The vertex rows' hash backward (sorted_segment_sum fed the sort's
permutation): its bytes (work.py) at the HBM peak over the device time a
launch of its instantiation with the most device time in the traced
segment, %. Nothing where the trace shows no such kernel, or the unit
completes no BA iterations."""
import tracing
import work


def read(run):
    if run.trace is None or run.units != "iters":
        return None
    nbytes = work.site_bytes(run.cfg, run.bucket).get("sorted_segment_sum")
    seen = tracing.kernel_time(run.trace, "segment_sum_kernel")
    if nbytes is None or seen is None or seen[1] <= 0:
        return None
    n, s = seen
    return 100.0 * (nbytes / work.PEAK_BYTES_S) / (s / n)
