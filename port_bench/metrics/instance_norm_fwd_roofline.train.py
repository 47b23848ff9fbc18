"""The IN forward kernels' (``in_fwd_*``) share of their roofline in
the training window: the least time of every step's 14 sites (each input
byte read once, each output byte written once, at the card's memory
rate) over the kernels' device time in the trace, in %."""

ITEMSIZE = {"bf16": 2, "f32": 4}


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    from counts.peaks import least_seconds

    device = run.trace.kernel_seconds(r"^in_fwd_")
    if device <= 0:
        return None
    side = run.traffic["image_size"]
    prec = run.config["precision"]
    least = sum(least_seconds(*run.counts.in_fwd_cost(n, side, side, ITEMSIZE[prec]), prec,
                              run.peaks)
                for _, _, n in run.steps)
    return 100.0 * least / device
