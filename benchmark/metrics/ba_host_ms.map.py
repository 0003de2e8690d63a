"""Host ms a BA call in the window (the harness's clock around
Mapper._ba_impl), the median."""
import statistics


def read(run):
    if run.kind != "map" or not run.unit_s:
        return None
    return statistics.median(run.unit_s) * 1e3
