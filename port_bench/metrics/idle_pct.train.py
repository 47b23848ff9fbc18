"""Share of the traced training window in which no operation ran on the
card (union of the trace's device intervals), in %."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
