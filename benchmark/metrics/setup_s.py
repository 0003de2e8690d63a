"""Set-up seconds: from the process's start to the window's (imports,
kernel builds, frames, warm-up, captures, the checked calls)."""


def read(run):
    return run.setup_s
