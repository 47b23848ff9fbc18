"""Device-idle time inside the training step's update (the program's
``train.update`` spans: clip, decay, Adam and the logged metrics enqueued
after the host read the loss) over the window, in %."""

from harness import program_spans


def read(run):
    spans = program_spans.intervals(run, "train.update")
    if spans is None:
        return None
    return 100.0 * program_spans.idle_within_s(run, spans) / run.trace.window_s
