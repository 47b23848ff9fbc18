"""The training runner: the CLI's training job as ``train/loop.py`` makes
its calls, bounded by time from outside. ``InputPipeline`` reads a seeded
folder of JPEGs that each run writes under ``TMPDIR``; ``make_train_step``'s
step runs on each batch. Set-up drives the first three steps through the
same step and feed, which the reference then follows; the window runs on.
Host spans: "window", "input_wait" (blocked on the next batch) and "step"."""

import gc
import os
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from harness import seeded
from harness.trace import Tracer
from reference import stylenet as ref_net
from reference import vgg as ref_vgg

CHECKED_STEPS = 3


def write_folder(root: str, traffic: dict, seed: int, device) -> str:
    """``traffic["images"]`` JPEGs, each side spread over [side_min,
    side_max], cropped from a few seeded source images."""
    from PIL import Image

    n, lo, hi = traffic["images"], traffic["side_min"], traffic["side_max"]
    rng = np.random.default_rng(seeded.sub_seed(seed, 20))
    hs, ws = seeded.spread_sizes(n, lo, hi, rng), seeded.spread_sizes(n, lo, hi, rng)
    pool = seeded.images(8, hi, hi, seeded.sub_seed(seed, 21), device)
    src = rng.integers(0, len(pool), n)
    oy, ox = rng.integers(0, hi - hs + 1), rng.integers(0, hi - ws + 1)
    folder = os.path.join(root, "images")
    os.makedirs(folder)

    def save(i):
        img = pool[src[i], oy[i]:oy[i] + hs[i], ox[i]:ox[i] + ws[i]]
        Image.fromarray(np.ascontiguousarray(img)).save(
            os.path.join(folder, f"{i:04d}.jpg"), quality=traffic["jpeg_quality"])

    with ThreadPoolExecutor(max_workers=traffic["workers"]) as pool_x:
        list(pool_x.map(save, range(n)))
    return folder


class Job:
    """The program's training job, set up from the seed."""

    def __init__(self, cell, seed: int, device, tracer: Tracer, root: str):
        from fast_neural_style_transfer_tpu_torch.core.dtypes import canonical_compute_dtype
        from fast_neural_style_transfer_tpu_torch.data import ImageFolderDataset, InputPipeline
        from fast_neural_style_transfer_tpu_torch.losses import (
            LossTaps,
            style_targets_from_features,
        )
        from fast_neural_style_transfer_tpu_torch.models.transformer import TransformerNet
        from fast_neural_style_transfer_tpu_torch.models.vgg_weights import make_vgg
        from fast_neural_style_transfer_tpu_torch.train.schedule import LossWeightSchedule
        from fast_neural_style_transfer_tpu_torch.train.state import create_train_state
        from fast_neural_style_transfer_tpu_torch.train.step import exact_f32, make_train_step
        from fast_neural_style_transfer_tpu_torch.utils.image_io import normalize_image

        cfg, traffic = cell.config, cell.traffic
        self.cell, self.device, self.tracer = cell, device, tracer
        self.batch_size = traffic["batch_size"]
        side = traffic["image_size"]
        self.folder = write_folder(root, traffic, seed, device)
        self.weights = seeded.weights(ref_net.param_spec(), seeded.sub_seed(seed, 1), device)
        self.vgg_weights = seeded.weights(ref_vgg.param_spec(), seeded.sub_seed(seed, 2), device)
        self.style = seeded.images(1, side, side, seeded.sub_seed(seed, 3), device)[0]
        self.pipe_seed = seeded.sub_seed(seed, 4) % (2 ** 32)
        self.gen_seed = seeded.sub_seed(seed, 5)
        self.lr, self.total_steps = traffic["lr"], traffic["total_steps"]
        prec = canonical_compute_dtype(cfg["precision"])
        exact_f32(device, prec)
        taps = LossTaps()
        self.vgg = make_vgg(self.vgg_weights, device)
        style = torch.from_numpy(normalize_image(self.style[None])).to(device)
        with torch.no_grad():
            self.grams = [g.detach() for g in style_targets_from_features(
                self.vgg(style, taps.style_taps, precision=prec))]
        net = TransformerNet()
        net.load_state_dict(self.weights, strict=True)
        net = net.to(device, memory_format=torch.channels_last)
        self.state = create_train_state(net, self.lr, self.total_steps)
        self.step_fn = make_train_step(taps=taps, weight_schedule=LossWeightSchedule(),
                                       precision=prec, lr=self.lr, total_steps=self.total_steps)
        dataset = ImageFolderDataset(self.folder, (side, side), seed=self.pipe_seed)
        self.pipeline = InputPipeline(dataset, self.batch_size, seed=self.pipe_seed,
                                      num_workers=traffic["workers"],
                                      prefetch=traffic["prefetch"],
                                      transport=traffic["transport"], device=device)
        self.generator = torch.Generator(device=device).manual_seed(self.gen_seed)
        self.batches = self.pipeline.device_batches()
        self.steps = []  # (start, end, images), host clock
        self.input_wait_s = 0.0

    def step(self):
        """One step as the loop makes it: the next batch, then the step."""
        t0 = time.perf_counter()
        with self.tracer.span("input_wait"):
            batch = next(self.batches)
        t1 = time.perf_counter()
        with self.tracer.span("step"):
            metrics = self.step_fn(self.state, self.vgg, batch, self.grams, self.generator)
        self.input_wait_s += t1 - t0
        self.steps.append((t0, time.perf_counter(), int(batch.shape[0])))
        return metrics

    def checked_steps(self):
        """The first steps, with what the reference is compared on: each
        step's loss, the gradient Adam got at step 1 (its first moment over
        1 - beta1) and the parameters after the last."""
        losses = []
        for k in range(CHECKED_STEPS):
            losses.append(float(self.step()["loss"]))
            if k == 0:
                opt = self.state.optimizer
                beta1 = opt.adam.param_groups[0]["betas"][0]
                # a step that made no update left Adam no state: it got nothing
                first = {name: (opt.adam.state[p]["exp_avg"] / (1.0 - beta1)).detach().clone()
                         if "exp_avg" in opt.adam.state.get(p, {}) else torch.zeros_like(p)
                         for name, p in self.state.net.named_parameters()}
        after = {name: p.detach().clone() for name, p in self.state.net.named_parameters()}
        self.checked = (losses, first, after)
        self.steps.clear()
        self.input_wait_s = 0.0

    def close(self):
        self.batches.close()  # stops and joins the pipeline's producer


def reference_batches(folder: str, pipe_seed: int, batch: int, side: int, steps: int):
    """The first ``steps`` batches as the pipeline's order gives them: the
    sorted files, epoch 0's permutation by the seed; each file decoded to
    RGB and resized bilinearly to side x side."""
    from PIL import Image

    files = sorted(os.path.join(folder, f) for f in os.listdir(folder))
    order = np.random.default_rng(pipe_seed).permutation(len(files))
    out = []
    for k in range(steps):
        imgs = []
        for i in order[k * batch:(k + 1) * batch]:
            with Image.open(files[i]) as im:
                imgs.append(np.asarray(im.convert("RGB").resize((side, side), Image.BILINEAR),
                                       np.uint8))
        out.append(np.stack(imgs))
    return out


def judge(job: Job, device, tf32: bool = False) -> dict:
    """The program's first steps against the reference's (float32, TF32
    off; ``tf32`` gives the control). Each number is a gap against the
    reference: the largest relative gap of a step's loss; the worst leaf's
    gap between the norms of the gradient Adam got, and of the parameters'
    change over the steps, each over the reference's norm of that leaf or of
    the median leaf, whichever is larger. Leaves whose loss gradient in the
    reference is under a thousandth of the median leaf's (conv biases under
    instance norm) are left out of the change: Adam moves them by rounding."""
    from reference.common import float32_math
    from reference.train import train

    losses, first, after = job.checked
    batches = [torch.from_numpy(b).to(device) for b in reference_batches(
        job.folder, job.pipe_seed, job.batch_size, job.cell.traffic["image_size"],
        len(losses))]
    gen = torch.Generator(device=device).manual_seed(job.gen_seed)
    with float32_math(tf32):
        r_losses, r_first, r_raw, r_after = train(job.weights, job.vgg_weights, batches,
                                                  torch.from_numpy(job.style).to(device), gen,
                                                  lr=job.lr, total_steps=job.total_steps)
    return compare(losses, first, after, job.weights, r_losses, r_first, r_raw, r_after)


def _norms(d: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in d.items()}


def compare(losses, first, after, start, r_losses, r_first, r_raw, r_after) -> dict:
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, r_losses))
    loss1_gap = abs(losses[0] - r_losses[0]) / abs(r_losses[0])
    g, rg, raw = _norms(first), _norms(r_first), _norms(r_raw)
    med = float(np.median(list(rg.values())))
    grad_gap = max(abs(g[k] - rg[k]) / max(rg[k], med) for k in rg)
    raw_med = float(np.median(list(raw.values())))
    moved = [k for k in raw if raw[k] >= 1e-3 * raw_med]
    ch = _norms({k: after[k].float() - start[k].float() for k in moved})
    rch = _norms({k: r_after[k].float() - start[k].float() for k in moved})
    cmed = float(np.median(list(rch.values())))
    change_gap = max(abs(ch[k] - rch[k]) / max(rch[k], cmed) for k in moved)
    return {"loss_gap": loss_gap, "loss1_gap": loss1_gap, "grad_gap": grad_gap, "change_gap": change_gap,
            "leaves_left_out": float(len(raw) - len(moved))}


class Record:
    """What a training run saw; the metric readers take it."""


def run(cell, seed: int, seconds: float, device, trace: bool, t_start: float,
        judge_it: bool = True) -> Record:
    tracer = Tracer(trace)
    rec = Record()
    rec.config, rec.traffic = cell.config, cell.traffic
    with tempfile.TemporaryDirectory(prefix="port_bench_train_") as root:
        job = Job(cell, seed, device, tracer, root)
        try:
            job.checked_steps()
            tracer.warm(device)
            gc.collect()
            gc.freeze()  # set-up's objects out of the collector's way
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            tracer.start()
            t0 = time.perf_counter()
            rec.setup_s = t0 - t_start
            with tracer.span("window"):
                while time.perf_counter() - t0 < seconds:
                    job.step()
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
            t1 = time.perf_counter()
            rec.trace = tracer.stop()
        finally:
            job.close()
        rec.window_s = t1 - t0
        rec.memory_peak_bytes = (torch.cuda.max_memory_allocated(device)
                                 if device.type == "cuda" else 0)
        rec.steps = list(job.steps)
        rec.images = sum(n for _, _, n in rec.steps)
        rec.input_wait_s = job.input_wait_s
        rec.attempted = len(rec.steps) + CHECKED_STEPS
        rec.failed = 0
        rec.host_spans = ("input_wait", "step")
        rec.idle_label = "loop"
        job.state = job.vgg = job.step_fn = job.pipeline = None
        if device.type == "cuda":
            torch.cuda.empty_cache()
        rec.checks = judge(job, device) if judge_it else {}
    return rec
