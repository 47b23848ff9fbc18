"""The batcher's own host work per batch: pad and stack, then handing the
outputs to their callers, in ms (the program's ``ServingStats``:
``mean_pad_stack_ms + mean_deliver_ms``). The device waits through both
when the batches come back to back."""


def read(run):
    pad, deliver = run.stats.get("mean_pad_stack_ms"), run.stats.get("mean_deliver_ms")
    return pad + deliver if pad is not None and deliver is not None else None
