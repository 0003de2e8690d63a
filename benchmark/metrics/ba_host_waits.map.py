"""Host waits for the device (``ba.wait`` spans) a BA call in the window,
the mean (the program's spans)."""
import program_spans


def read(run):
    calls = program_spans.window_calls(run)
    if not calls:
        return None
    waits = sum(r.name == "ba.wait" for spans in calls for r in spans)
    return waits / len(calls)
