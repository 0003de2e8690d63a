"""Device ms of a mapping step's map-volume query (the program's
``volumes.query`` span: the chunked query and the uncertainty volume's
refresh, timed by its CUDA event pair), the median over the window's
steps."""
import statistics

import step_spans


def read(run):
    ms = step_spans.query_ms(run)
    return statistics.median(ms) if ms else None
