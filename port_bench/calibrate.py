"""Readings that set the benchmark's numbers, run on the card by hand, never
by the benchmark's own runs:

    python3 port_bench/calibrate.py sweep --workload <cell> --rates 120,160,200 --seconds 8
    python3 port_bench/calibrate.py limits --workload <cell> --seeds 12 --control-seeds 3

``sweep`` offers an open-loop (Poisson) cell's traffic at each rate and prints
whether completions kept up (the knee is the highest rate with no backlog
growing to the window's close). ``limits`` prints the numbers the cell
compares for sound runs of the program over many seeds, and for the
lower-precision control (and, for training, the planted fault of half a
batch left out) over a few: each limit lies between the two.
Everything goes to standard output as JSON lines.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]
os.environ.setdefault("OMP_NUM_THREADS", "1")  # as run.py

from harness import guard, spec  # noqa: E402


def emit(**fields):
    print(json.dumps(fields), flush=True)


def sweep(cell, rates, seconds: float, seed: int, device) -> None:
    import numpy as np

    from harness import serving

    for rate in rates:
        cell.params = dict(cell.params, rate_per_s=rate)
        rec = serving.run(cell, seed, seconds, device, False, time.perf_counter(), judge=False)
        end = rec.t0 + seconds
        outstanding = int(np.sum((rec.due <= end) & ~(rec.done <= end)))
        lat = rec.latency_ms
        tail = lat[int(0.8 * len(lat)):]
        emit(kind="sweep", workload=cell.name, rate=rate, attempted=rec.attempted,
             failed=rec.failed, outstanding_at_close=outstanding,
             p50_ms=float(np.percentile(lat, 50)), p95_ms=float(np.percentile(lat, 95)),
             p95_last_fifth_ms=float(np.percentile(tail, 95)),
             occupancy=rec.stats["mean_batch_occupancy"])


def serving_limits(cell, seeds, control_seeds, seconds: float, base: int, device) -> None:
    """The program, served at the cell's load; the control (the cell's
    lower precision) on the same kind of sample, padded to its bucket and
    run in batches of the cell's largest size, since a reference in the
    program's place cannot keep up with the load."""
    import numpy as np

    from harness import seeded, serving
    from harness.systems import for_arch

    for k in range(seeds):
        seed = base + 1000 + 7919 * k
        rec = serving.run(cell, seed, seconds, device, False, time.perf_counter())
        emit(kind="limits", workload=cell.name, variant="program", seed=seed,
             failed=rec.failed, **rec.checks)
    system = for_arch(cell.config["arch"])
    traffic = cell.traffic
    from reference.common import pad_to_bucket
    for k in range(control_seeds):
        seed = base + 2000 + 7919 * k
        weights = system.make_weights(seed, device)
        sched = serving.Schedule(traffic, cell.params, seconds, seed)
        side = traffic["side_max"]
        pool = seeded.images(serving.POOL, side, side, seeded.sub_seed(seed, 11), device)
        imgs = [sched.image(pool, i) for i in sched.sample(range(sched.n))]
        control = system.serve_forward(cell.config, weights, traffic, device, "control")
        outs, mb = [], traffic["max_batch"]
        for at in range(0, len(imgs), mb):
            chunk = imgs[at:at + mb]
            y = control(np.stack([pad_to_bucket(im, traffic["bucket_multiple"]) for im in chunk]))
            outs += [yi[:im.shape[0], :im.shape[1]] for yi, im in zip(y, chunk)]
        refs = system.reference_u8(weights, imgs, traffic["bucket_multiple"], device)
        emit(kind="limits", workload=cell.name, variant="control", seed=seed,
             **serving.compare_u8(outs, refs))


def training_limits(cell, seeds, control_seeds, base: int, device) -> None:
    import tempfile

    import torch

    from harness import training
    from harness.trace import Tracer
    from reference.common import float32_math
    from reference.train import train

    def job_for(seed, root):
        return training.Job(cell, seed, device, Tracer(False), root)

    for k in range(seeds):
        seed = base + 1000 + 7919 * k
        with tempfile.TemporaryDirectory() as root:
            job = job_for(seed, root)
            try:
                job.checked_steps()
            finally:
                job.close()
            emit(kind="limits", workload=cell.name, variant="program", seed=seed,
                 **training.judge(job, device))
    for k in range(control_seeds):
        seed = base + 2000 + 7919 * k
        with tempfile.TemporaryDirectory() as root:
            job = job_for(seed, root)
            job.close()
            # the control: the reference computed in TF32, in the program's place
            batches = [torch.from_numpy(b).to(device) for b in training.reference_batches(
                job.folder, job.pipe_seed, job.batch_size, cell.traffic["image_size"],
                training.CHECKED_STEPS)]
            gen = torch.Generator(device=device).manual_seed(job.gen_seed)
            with float32_math(tf32=True):
                losses, first, _, after = train(job.weights, job.vgg_weights, batches,
                                                torch.from_numpy(job.style).to(device), gen,
                                                lr=job.lr, total_steps=job.total_steps)
            job.checked = (losses, first, after)
            emit(kind="limits", workload=cell.name, variant="control_tf32", seed=seed,
                 **training.judge(job, device))
        # the fault: half of each batch left out, the rest counted twice
        seed = base + 3000 + 7919 * k
        with tempfile.TemporaryDirectory() as root:
            job = job_for(seed, root)
            inner = job.step_fn

            def half(state, vgg, batch, grams, generator, inner=inner):
                h = batch.shape[0] // 2
                return inner(state, vgg, torch.cat([batch[:h], batch[:h]]), grams, generator)

            job.step_fn = half
            try:
                job.checked_steps()
            finally:
                job.close()
            emit(kind="limits", workload=cell.name, variant="fault_half_batch", seed=seed,
                 **training.judge(job, device))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("what", choices=("sweep", "limits"))
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", default="")
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--seed", type=int, default=2 ** 31 + 17)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--seed-base", type=int, default=2 ** 31,
                   help="limits: the program's seeds are base + 1000 + 7919 k, the control's base + 2000 + ...")
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)
    guard.require_cards(cell.chips)
    import torch

    device = torch.device("cuda", 0)
    emit(kind="device", name=torch.cuda.get_device_name(device))
    if args.what == "sweep":
        sweep(cell, [float(r) for r in args.rates.split(",")], args.seconds, args.seed, device)
    elif cell.traffic["kind"] == "training":
        training_limits(cell, args.seeds, args.control_seeds, args.seed_base, device)
    else:
        serving_limits(cell, args.seeds, args.control_seeds, args.seconds, args.seed_base, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
