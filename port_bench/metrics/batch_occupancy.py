"""Images per device batch, from the batcher's own counters
(``ServingStats.batched_images / batches``)."""


def read(run):
    b = run.stats.get("batches") or 0
    return run.stats["batched_images"] / b if b else None
