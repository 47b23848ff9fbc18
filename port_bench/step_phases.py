"""The training step's host phases with the profiler and without it: how
far ``torch.profiler``'s per-operator recording in a ``--trace 1`` run
stretches each of the program's ``train.*`` spans.

    python3 port_bench/step_phases.py --seed <n> --seconds <s>

Sets up the training cell's job as ``harness/training.py`` does, then runs
three windows of ``--seconds`` on the card: without a profiler, under the
profiler of a ``--trace 1`` run, and without one again. Without a profiler
the program's span recorder is switched on by setting its gate,
``torch.autograd.profiler._is_profiler_enabled``, by hand: the spans read
the clock and nothing records the operators. Prints one JSON line: per
window, the steps made, ms a step, and each span's mean ms a step."""

import argparse
import gc
import json
import os
import sys
import tempfile
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]
os.environ.setdefault("OMP_NUM_THREADS", "1")  # as run.py

import torch  # noqa: E402
import torch.autograd.profiler as autograd_profiler  # noqa: E402

from harness import spec, training  # noqa: E402
from harness.trace import Tracer  # noqa: E402

CELL = "stylenet-ref.train.256"
PHASES = ("pipeline.wait", "train.loss", "train.grad", "train.sync", "train.update")


def window(job, seconds: float, profiled: bool) -> dict:
    from fast_neural_style_transfer_tpu_torch.utils import tracing

    job.tracer = tracer = Tracer(profiled)
    tracer.warm(job.device)
    tracing.clear()
    job.steps.clear()
    torch.cuda.synchronize(job.device)
    tracer.start()
    if not profiled:
        autograd_profiler._is_profiler_enabled = True
    try:
        with tracer.span("window"):
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                job.step()
            torch.cuda.synchronize(job.device)
    finally:
        if not profiled:
            autograd_profiler._is_profiler_enabled = False
    tracer.stop()
    spans, n = tracing.spans(), len(job.steps)
    out = {"profiled": profiled, "steps": n,
           "ms_per_step": (job.steps[-1][1] - job.steps[0][0]) * 1e3 / n}
    for name in PHASES:
        out[name] = sum(s.end_ns - s.start_ns for s in spans if s.name == name) / 1e6 / n
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    cell = spec.load_cell(CELL)
    with tempfile.TemporaryDirectory(prefix="port_bench_phases_") as root:
        job = training.Job(cell, args.seed, device, Tracer(False), root)
        try:
            job.checked_steps()
            gc.collect()
            gc.freeze()
            windows = [window(job, args.seconds, profiled) for profiled in (False, True, False)]
        finally:
            job.close()
    print(json.dumps({"cell": CELL, "seed": args.seed, "device": torch.cuda.get_device_name(device),
                      "windows": windows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
