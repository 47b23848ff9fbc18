"""The batcher's wait for company per batch, from picking the head request
to taking the group, in ms (the program's ``ServingStats.mean_linger_ms``)."""


def read(run):
    return run.stats.get("mean_linger_ms")
