"""Device ms a BA iteration spends in its backward pass
(torch.autograd.grad), from the timing events inside the BA graph
replayed last (the traced segment's last call): the stage's sum over the
call's iterations, over their number."""
import program_spans


def read(run):
    return program_spans.stage_ms(run, "backward")
