"""The IN forward kernels' (``in_fwd_*``) share of their roofline while
serving: the least time of every forward's IN sites (each input byte read
once, each output byte written once, at the card's memory rate) over the
kernels' device time in the trace, in %."""

ITEMSIZE = {"bf16": 2, "f32": 4}


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    from counts.peaks import least_seconds

    device = run.trace.kernel_seconds(r"^in_fwd_")
    if device <= 0:
        return None
    least = sum(least_seconds(*run.counts.in_fwd_cost(n, h, w, ITEMSIZE[run.config["precision"]]),
                              "f32", run.peaks)
                for _, _, n, h, w in run.forwards)
    return 100.0 * least / device
