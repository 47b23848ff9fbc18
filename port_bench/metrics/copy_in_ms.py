"""Mean host time of the stylizer's copy in per forward call (the batch
from numpy to the card: the program's ``stylize.copy_in`` spans in the
window), in ms."""

from harness import program_spans


def read(run):
    spans = program_spans.intervals(run, "stylize.copy_in")
    return program_spans.total_s(spans) * 1e3 / len(spans) if spans else None
