"""Images answered within the window over the window's seconds: the
served throughput of a cell whose clients keep every batch full (requests
the batcher refuses are not counted; answers after the close are not)."""

import numpy as np


def read(run):
    ok = np.isfinite(run.latency_ms) & (run.done <= run.t0 + run.seconds)
    return float(ok.sum()) / run.seconds
