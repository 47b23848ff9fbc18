"""Share of the time the host spends enqueuing the device's work in which
no operation ran on the card (union of the trace's device intervals), in %:
the program's ``stylize.launch`` spans when serving (pad, network, u8 out),
``train.loss`` and ``train.grad`` when training (forward, losses,
backward). Idle there means the host's launches, not the device, set the
pace."""

from harness import program_spans

LAUNCH_SPANS = ("stylize.launch", "train.loss", "train.grad")


def read(run):
    spans = [iv for name in LAUNCH_SPANS for iv in program_spans.intervals(run, name) or ()]
    total = program_spans.total_s(spans)
    if total <= 0:
        return None
    return 100.0 * program_spans.idle_within_s(run, spans) / total
