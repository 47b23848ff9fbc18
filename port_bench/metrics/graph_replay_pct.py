"""Share of the window's stylizer forwards that replayed a CUDA graph: the
program's ``stylize.launch`` spans that contain a ``stylize.replay`` span,
over all of them, in %. None where the program records no
``stylize.replay`` (it has no graphs, or serves without them)."""

from harness import program_spans


def read(run):
    launches = program_spans.intervals(run, "stylize.launch")
    replays = program_spans.intervals(run, "stylize.replay")
    if not launches or not replays:
        return None
    replays = sorted(replays)
    replayed, i = 0, 0
    for s, e in sorted(launches):
        while i < len(replays) and replays[i][0] < s:
            i += 1
        replayed += i < len(replays) and replays[i][1] <= e
    return 100.0 * replayed / len(launches)
