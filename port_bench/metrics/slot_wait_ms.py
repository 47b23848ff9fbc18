"""A batch's wait in the batcher's handoff slot, from its first requests
padded and stacked to its forward's start, in ms (the program's
``ServingStats.mean_slot_ms``): the time a prepared batch waits for the
forward before it. A program without the slot reads None."""


def read(run):
    return run.stats.get("mean_slot_ms")
