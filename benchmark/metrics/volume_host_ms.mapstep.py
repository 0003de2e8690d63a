"""Host ms of a mapping step's SDF host copy (the program's
``volumes.host`` span of volume 1, inside ``LazyVolumes.host``: the
pinned copy alone, after the wait for the query), the median over the
window's steps."""
import statistics

import step_spans


def read(run):
    ms = step_spans.host_ms(run)
    return statistics.median(ms) if ms else None
