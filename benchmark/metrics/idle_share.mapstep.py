"""Share of the traced segment's window (mapping steps) in which no
kernel, copy or fill ran on the device (profiler), %."""


def read(run):
    if run.trace is None or run.kind != "mapstep" \
            or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
