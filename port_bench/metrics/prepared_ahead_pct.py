"""The share of batches the batcher padded and stacked before its dispatcher
was free for them, in % (the program's ``ServingStats.prepared_ahead_share``):
the batches whose host work the device did not wait for. A program without
the prepare stage reads None."""


def read(run):
    share = run.stats.get("prepared_ahead_share")
    return None if share is None else 100.0 * share
