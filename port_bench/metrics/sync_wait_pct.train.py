"""Share of the training window the host spent reading the loss's
finiteness (the program's ``train.sync`` spans), which waits for the
device to finish the step's forward and backward, in %. A diagnostic, with
no direction that holds: a faster enqueue of the forward reaches the read
sooner and waits longer there, so it rises with a real gain in
``train_img_per_s``; device-idle time after the read is
``idle_in_update_pct.train``'s."""

from harness import program_spans


def read(run):
    spans = program_spans.intervals(run, "train.sync")
    if spans is None:
        return None
    return 100.0 * program_spans.total_s(spans) / run.trace.window_s
