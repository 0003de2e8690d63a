"""Host ms of a BA call from the end of its last wait for the device
(``ba.wait``; from the call's start where it has none) to the end of its
graph launch (``ba.launch``): the stretch in which the card runs only the
draws and copies the host enqueues. The median over the window's calls
(the program's spans)."""
import statistics

import program_spans


def read(run):
    calls = program_spans.window_calls(run)
    if not calls:
        return None
    paths = []
    for spans in calls:
        launch = [r for r in spans if r.name == "ba.launch"]
        if not launch:
            continue
        waits = [r.end_ns for r in spans if r.name == "ba.wait"]
        start = max(waits) if waits else spans[-1].start_ns
        paths.append((launch[-1].end_ns - start) * 1e-6)
    return statistics.median(paths) if paths else None
