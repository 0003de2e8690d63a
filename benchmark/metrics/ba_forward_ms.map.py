"""Device ms a BA iteration spends in its forward pass (the field, render
and losses), from the timing events inside the BA graph replayed last
(the traced segment's last call): the stage's sum over the call's
iterations, over their number."""
import program_spans


def read(run):
    return program_spans.stage_ms(run, "forward")
