"""Device-idle time inside the batcher's pad and stack of each batch on the
host (the program's ``batcher.pad_stack`` spans: every request padded to
the bucket, then stacked) over the window, in %."""

from harness import program_spans


def read(run):
    spans = program_spans.intervals(run, "batcher.pad_stack")
    if spans is None:
        return None
    return 100.0 * program_spans.idle_within_s(run, spans) / run.trace.window_s
