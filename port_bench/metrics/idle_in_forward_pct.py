"""Share of the time inside the program's forward calls in which no
operation ran on the card (union of the trace's device intervals), in %.
Idle time between requests is set by the traffic and is not counted."""


def read(run):
    if run.trace is None:
        return None
    spans = run.trace.spans.get("forward", [])
    total = sum(e - s for s, e in spans) / 1e6
    if total <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_within(spans) / total)
