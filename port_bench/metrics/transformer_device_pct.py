"""The transformer's share of StyTr²'s forward on the device: the device
time of the program's ``stytr2.embed``, ``stytr2.encode`` and
``stytr2.decode`` stage spans over that of those three and ``stytr2.cnn``
(the AdaIN decoder), summed over the window's batches, in %. A program
without the stage spans reads None.

A stage's device time (``utils.tracing.device_ms``) is the time between two
CUDA timing events the program records on the stream at the stage's
bounds: the stage's kernels and the stream's idle gaps between them, where
the device waits for the host to launch the next. It is not kernel time
alone.

A diagnostic with no direction that holds: a faster transformer (a fused
projection, Hopper's FlashAttention) lowers the share while served img/s
rises, a faster AdaIN decoder raises it. Its entry says "lower", the
direction of the transformer, the mechanism the cell exists to measure."""

from harness import program_spans

TRANSFORMER = ("stytr2.embed", "stytr2.encode", "stytr2.decode")
STAGES = TRANSFORMER + ("stytr2.cnn",)


def read(run):
    spans, at = program_spans.buffer(), program_spans.serving_offset(run)
    if spans is None or at is None:
        return None
    from fast_neural_style_transfer_tpu_torch.utils import tracing

    device_ms = getattr(tracing, "device_ms", None)
    if device_ms is None:
        return None
    w0, w1 = run.trace.window
    ms = dict.fromkeys(STAGES, 0.0)
    for s in spans:
        if s.name in ms and w0 <= s.start_ns / 1e3 + at < w1:
            t = device_ms(s)
            if t is None:
                return None
            ms[s.name] += t
    total = sum(ms.values())
    return 100.0 * sum(ms[n] for n in TRANSFORMER) / total if total > 0 else None
