"""VGG conv1_1's input-gradient kernel's share of its roofline in the
training window: the least time of every step's call (operations at the
configuration's peak; the output gradient and weights read once, dx written
once) over the kernel's device time in the trace, in %."""

ITEMSIZE = {"bf16": 2, "f32": 4}


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    from counts.peaks import least_seconds

    device = run.trace.kernel_seconds(r"^(conv_dx_tap_packed|conv_same_bwd_kernel)$")
    if device <= 0:
        return None
    side = run.traffic["image_size"]
    prec = run.config["precision"]
    least = sum(least_seconds(*run.counts.conv_dx_cost(n, side, side, ITEMSIZE[prec]), prec,
                              run.peaks)
                for _, _, n in run.steps)
    return 100.0 * least / device
