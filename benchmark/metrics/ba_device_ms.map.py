"""Device ms a BA call in the window (CUDA events around each call), the
median."""
import statistics


def read(run):
    if run.kind != "map" or not run.unit_device_ms:
        return None
    return statistics.median(run.unit_device_ms)
