"""95th percentile latency of all requests due in the window, each from its
due time to its answer (open loop); failed requests count as missing."""

import numpy as np


def read(run):
    v = float(np.percentile(run.latency_ms, 95))
    return v if np.isfinite(v) else None
