"""AdaAttN's own modules' share of its forward on the device: the device
time of the program's ``adaattn.keys`` (the key builder and the query
projections) and ``adaattn.attend`` (the three moment attentions) stage
spans over that of those two, ``adaattn.encode`` (VGG19 to relu5_1) and
``adaattn.decode`` (merge conv and decoder), summed over the window's
batches, in %. A program without the stage spans reads None.

A stage's device time (``utils.tracing.device_ms``) is the time between two
CUDA timing events the program records on the stream at the stage's
bounds: its kernels and the stream's idle gaps between them. A diagnostic
of where the time goes, with no direction that holds: a faster attention
lowers it, a faster encoder or decoder raises it. Its entry says "lower",
the direction of the attention, the mechanism the cell exists to
measure."""

from harness import program_spans

ADAATTN = ("adaattn.keys", "adaattn.attend")
STAGES = ADAATTN + ("adaattn.encode", "adaattn.decode")


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
    return 100.0 * sum(ms[n] for n in ADAATTN) / total if total > 0 else None
