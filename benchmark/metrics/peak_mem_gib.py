"""The device's peak allocated memory over set-up and the window, GiB."""


def read(run):
    return run.peak_bytes / 2 ** 30
