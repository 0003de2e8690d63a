"""BA iterations completed in the window over the window's seconds (the
clock stops after a synchronize), in every kind whose unit completes BA
iterations (its ``units`` is ``"iters"``)."""


def read(run):
    if run.units != "iters":
        return None
    return run.work / run.elapsed_s
