"""Share of the window's device-idle time that falls inside some program
span (the outermost ones, whose parent ids are empty, but a request's
``batcher.queued``), in %: how much of the idle time the program's spans
name. The rest is host work between them that no span covers."""

from harness import program_spans


def read(run):
    spans = program_spans.roots(run)
    if spans is None:
        return None
    idle = run.trace.window_s - run.trace.busy_s
    if idle <= 0:
        return None
    return 100.0 * program_spans.idle_within_s(run, spans) / idle
