"""The program's own spans (``fast_neural_style_transfer_tpu_torch/utils/
tracing.py``) on the trace's clock, for the metric readers.

A span opened on the thread that runs the profiler (the training loop's) is
in the trace natively, as a ``user_annotation``. The profiler records no
other thread, so the batcher's dispatcher's spans (``batcher.*``, ``stylize.*``)
are only in the program's buffer, on the host's ``perf_counter`` clock; they
are mapped by the offset the serving runner gave its own "forward" spans
(``Trace.add_host_spans``), the same anchor. A training run's buffer is
mapped by the offset between the runner's first native "input_wait" span
and the host clock it read just before it. A program without the
recorder, or a run without the span, reads None."""

from harness.trace import union

# a request's wait spans its batch's linger, and in a closed loop every
# moment of the window: no account of where the host was
NOT_A_PHASE = ("batcher.queued",)


def buffer():
    """The program's recorded spans, or None where it has no recorder."""
    try:
        from fast_neural_style_transfer_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing.spans()


def serving_offset(run):
    """Microseconds to add to a host-clock microsecond to place it on the
    trace's clock, from the runner's first "forward" span; None outside a
    traced serving run."""
    forwards = getattr(run, "forwards", None)
    if run.trace is None or not forwards or not run.trace.spans.get("forward"):
        return None
    return run.trace.spans["forward"][0][0] - forwards[0][0] * 1e6


def training_offset(run):
    """As ``serving_offset``, from the runner's first "input_wait" span and
    the host clock read just before it (``run.steps[0][0]``); None outside
    a traced training run."""
    steps = getattr(run, "steps", None)
    if run.trace is None or not steps or not run.trace.spans.get("input_wait"):
        return None
    return run.trace.spans["input_wait"][0][0] - steps[0][0] * 1e6


def _clip(run, raw):
    w0, w1 = run.trace.window
    return [(max(s, w0), min(e, w1)) for s, e in raw if e > w0 and s < w1] or None


def intervals(run, name: str):
    """``name``'s spans as [(start, end)] microseconds on the trace's clock,
    clipped to the window; None where there are none."""
    if run.trace is None:
        return None
    raw = run.trace.spans.get(name)
    if not raw:
        at, spans = serving_offset(run), buffer()
        if at is None or spans is None:
            return None
        raw = [(s.start_ns / 1e3 + at, s.end_ns / 1e3 + at) for s in spans if s.name == name]
    return _clip(run, raw)


def roots(run):
    """The outermost program spans (no enclosing span on their thread; a
    child lies inside its parent) but ``NOT_A_PHASE``'s, merged, on the
    trace's clock and clipped to the window; None where there are none."""
    if run.trace is None:
        return None
    at = serving_offset(run)
    at = training_offset(run) if at is None else at
    spans = buffer()
    if at is None or spans is None:
        return None
    raw = [(s.start_ns / 1e3 + at, s.end_ns / 1e3 + at) for s in spans
           if s.parent is None and s.name not in NOT_A_PHASE]
    out = _clip(run, raw)
    return [tuple(iv) for iv in union(out)] if out else None


def total_s(spans) -> float:
    return sum(e - s for s, e in spans) / 1e6


def idle_within_s(run, spans) -> float:
    """Seconds inside the spans in which no device operation ran."""
    return total_s(spans) - run.trace.busy_within(spans)
