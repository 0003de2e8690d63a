"""BA iterations completed in the window over the window's seconds (the
clock stops after a synchronize)."""


def read(run):
    if run.kind != "map":
        return None
    return run.work / run.elapsed_s
