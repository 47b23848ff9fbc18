"""The moment-attention kernel's share of its roofline while serving
AdaAttN: the least time of every served batch's three attentions at the
card's peaks (the operations at the configuration's precision, each query,
normalized content value and output byte moved once, the style's keys and
values once a batch: ``counts.<arch>.attention_cost``) over the device
time of ``moment_attention_kernel`` in the trace, in %. It reads None
where the trace's count of those kernels differs from the attention
launches the program counted in the window (the ``ops`` of its
``adaattn.attend`` spans), so that a launch the pattern misses shows as
missing, not as a number."""

import re

from harness import program_spans

KERNELS = re.compile(r"^moment_attention_kernel$")
STAGES = ("adaattn.attend",)
ITEMSIZE = {"bf16": 2, "f32": 4}


def launches(run):
    """The program's attention launches inside the trace's window, or None
    where the program left no stage spans."""
    spans, at = program_spans.buffer(), program_spans.serving_offset(run)
    if spans is None or at is None:
        return None
    w0, w1 = run.trace.window
    ops = [s.attrs.get("ops") for s in spans
           if s.name in STAGES and w0 <= s.start_ns / 1e3 + at < w1]
    return sum(ops) if ops and None not in ops else None


def read(run):
    if run.trace is None or run.peaks is None or not hasattr(run.counts, "attention_cost"):
        return None
    from counts.peaks import least_seconds
    from harness.trace import short_name

    kernels = [(s, e) for n, s, e in run.trace.ops if KERNELS.search(short_name(n))]
    if not kernels or launches(run) != len(kernels):
        return None
    precision = run.config["precision"]
    least = sum(least_seconds(*run.counts.attention_cost(n, h, w, ITEMSIZE[precision]),
                              precision, run.peaks)
                for _, _, n, h, w in run.forwards)
    return 100.0 * least / (sum(e - s for s, e in kernels) / 1e6)
