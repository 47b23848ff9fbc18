"""95th percentile of a request's wait in the batcher's queue, from its
submit to the batcher taking it into a batch, in ms (the program's
``batcher.queued`` spans in the window): the linger and the wait behind a
running batch, without pad, stack or forward."""

import numpy as np

from harness import program_spans


def read(run):
    spans = program_spans.intervals(run, "batcher.queued")
    if spans is None:
        return None
    return float(np.percentile([(e - s) / 1e3 for s, e in spans], 95))
