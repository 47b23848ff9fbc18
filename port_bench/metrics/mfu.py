"""The served images' operations, each counted at its own size (padding
is not useful work), over the forward calls' host-clock time and the
card's published dense peak at the configuration's precision, in %."""


def read(run):
    if run.peaks is None or not run.forwards:
        return None
    import numpy as np

    ok = np.isfinite(run.latency_ms)
    flops = sum(run.counts.forward_flops(int(h), int(w))
                for h, w in zip(run.heights[ok], run.widths[ok]))
    busy = sum(f[1] - f[0] for f in run.forwards)
    return 100.0 * flops / (busy * run.peaks["flops"][run.config["precision"]])
