"""Device-idle time inside the batcher's pad and stack (the program's
``batcher.pad_stack`` spans) but outside every running forward (its
``batcher.forward`` spans) over the window, in %: the idle time the device
spends waiting for the host to pad the next batch. Where the next batch is
padded while the forward before it runs, the idle time inside that forward
is the forward's own and is not counted here."""

from harness import program_spans
from harness.trace import union


def _minus(spans, cut):
    """The parts of the merged ``spans`` outside the merged ``cut``."""
    out = []
    for s, e in spans:
        at = s
        for cs, ce in cut:
            if ce <= at or cs >= e:
                continue
            if cs > at:
                out.append((at, cs))
            at = max(at, ce)
        if at < e:
            out.append((at, e))
    return out


def read(run):
    pads = program_spans.intervals(run, "batcher.pad_stack")
    if pads is None:
        return None
    forwards = program_spans.intervals(run, "batcher.forward") or []
    outside = _minus(union(pads), union(forwards))
    return 100.0 * program_spans.idle_within_s(run, outside) / run.trace.window_s
