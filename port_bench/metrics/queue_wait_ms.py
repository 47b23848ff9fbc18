"""95th percentile, over answered requests, of the wait from a request's
due time to the start of the forward that carried it (host clock; the
forward is the last one that ended before the answer came)."""

import numpy as np


def read(run):
    if not run.forwards:
        return None
    ends = np.array([f[1] for f in run.forwards])
    starts = np.array([f[0] for f in run.forwards])
    ok = np.isfinite(run.latency_ms)
    k = np.searchsorted(ends, run.done[ok], side="right") - 1
    good = k >= 0
    waits = (starts[k[good]] - run.due[ok][good]) * 1e3
    return float(np.percentile(waits, 95)) if len(waits) else None
