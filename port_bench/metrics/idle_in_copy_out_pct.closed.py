"""Device-idle time inside the stylizer's copy out (the program's
``stylize.copy_out`` spans: the ``.cpu()`` that waits for the forward,
then copies the batch to the host) over the window, in %."""

from harness import program_spans


def read(run):
    spans = program_spans.intervals(run, "stylize.copy_out")
    if spans is None:
        return None
    return 100.0 * program_spans.idle_within_s(run, spans) / run.trace.window_s
