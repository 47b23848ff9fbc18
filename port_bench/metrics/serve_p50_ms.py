"""Median latency of all requests due in the window, each from its due time
to its answer (open loop); a request that failed or never came counts as
missing every limit. Moves with the forward on the card."""

import numpy as np


def read(run):
    v = float(np.percentile(run.latency_ms, 50))
    return v if np.isfinite(v) else None
