"""Device ms a BA iteration spends sampling its rays (Mapper._ba_batch),
from the timing events inside the BA graph replayed last (the traced
segment's last call): the stage's sum over the call's iterations, over
their number."""
import program_spans


def read(run):
    return program_spans.stage_ms(run, "sample")
