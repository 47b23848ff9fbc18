"""The stylizer's final-conv kernel's share of its roofline while serving the
stylenet: the least time of every served batch's final conv (32 -> 3
channels, 9 x 9, stride 1: 2 n h w 3 32 81 operations at the
configuration's precision; x before its reflect pad, y and the weights and
bias each moved once, so that no way of computing it can read above 100 %)
over the device time of ``conv_to_rgb_kernel`` in the trace, in %. It reads
None where the trace holds no such kernel (a program that runs the conv
elsewhere) or a count of them other than the forwards the runner timed in
the window (one final conv each), so that a launch the pattern misses
shows as missing, not as a number."""

import re

KERNELS = re.compile(r"^conv_to_rgb_kernel$")
C_IN, C_OUT, K = 32, 3, 9
ITEMSIZE = {"bf16": 2, "f32": 4}


def final_conv_cost(n: int, h: int, w: int, itemsize: int):
    """(operations, bytes) of the final conv of an (n, h, w) batch."""
    flops = 2.0 * n * h * w * C_OUT * C_IN * K * K
    moved = (n * h * w * (C_IN + C_OUT) + C_OUT * C_IN * K * K + C_OUT) * itemsize
    return flops, moved


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    from counts.peaks import least_seconds
    from harness.trace import short_name

    kernels = [(s, e) for n, s, e in run.trace.ops if KERNELS.search(short_name(n))]
    if not kernels or len(kernels) != len(run.forwards):
        return None
    precision = run.config["precision"]
    least = sum(least_seconds(*final_conv_cost(n, h, w, ITEMSIZE[precision]), precision,
                              run.peaks)
                for _, _, n, h, w in run.forwards)
    return 100.0 * least / (sum(e - s for s, e in kernels) / 1e6)
