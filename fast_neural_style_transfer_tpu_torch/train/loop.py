"""The training loop (the JAX package's ``train/loop.py``) on one device.

The reference's cadences are kept: log every ``log_every`` steps, a monitor
sample every ``monitor_every``, a checkpoint every ``checkpoint_every``, the
final ``style_transfer_final.npz`` at the end. The style images' Gram
targets are computed once. SIGTERM (installed on the main thread only)
finishes the step in flight, then the ``finally`` block flushes the metrics
and leaves a restorable checkpoint. A resumed run continues from the
latest checkpoint's label.

Several style images train one multi-style net (conditional IN): per-layer
(S, c, c) Gram banks, ``TransformerNet(num_styles=S)``, a style drawn per
example each step, one monitor sample per style. ``init_checkpoint`` warm
starts the params (the style counts must match), or, for a reference
training ``.pth``, resumes fully (params, Adam state, schedule, step;
single-style only). ``in_stats="onepass"`` trains with one-pass IN
statistics.

Ranks, as the JAX package builds its mesh over every device with no flag:
with ``device`` None or "cuda" and more than one card, the loop spawns a
rank a card (``parallel/mesh.py::launch``) and the ranks form a (data,
space) mesh; ``spatial = N > 1`` splits each image's rows over N of them
(``train/spatial_step.py``), and the other factor, ranks // N, splits the
batch (data parallelism, ``train/step.py``: each rank decodes its slice
of the global batch, ``data/pipeline.py``). On one card, or with an
explicit ``cuda:N``, the loop runs in this process, as before, unless
``spatial`` > 1 asks for N ranks (sharing the card). Every rank runs this
loop; the batch must divide the data degree; rank 0 alone prints, logs,
samples and writes checkpoints and the final params, and every rank stops
at the same step. It keeps the JAX package's refusals with ``spatial``: a
height that is not a multiple of 8 * spatial, one-pass statistics,
several styles and ``pad_batch``. At the end rank 0 plots the loss
curves (``utils/visualization.py``; a plotting failure never fails the
run). ``profile_start`` / ``profile_stop`` trace those steps with
``torch.profiler`` into ``<output_dir>/profile``.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import threading
import time
from typing import Optional, Tuple, Union

import torch

from fast_neural_style_transfer_tpu_torch.core.dtypes import canonical_compute_dtype, exact_f32
from fast_neural_style_transfer_tpu_torch.core.shapes import resolve_device
from fast_neural_style_transfer_tpu_torch.data import ImageFolderDataset, InputPipeline
from fast_neural_style_transfer_tpu_torch.losses import LossTaps, style_targets_from_features
from fast_neural_style_transfer_tpu_torch.models.transformer import (
    TransformerNet,
    bake_style,
    num_styles,
)
from fast_neural_style_transfer_tpu_torch.models.vgg_weights import make_vgg, resolve_params
from fast_neural_style_transfer_tpu_torch.models.weights import load_checkpoint, save_params_npz
from fast_neural_style_transfer_tpu_torch.parallel.mesh import ReplicaPlan
from fast_neural_style_transfer_tpu_torch.train.checkpoint import CheckpointManager
from fast_neural_style_transfer_tpu_torch.train.schedule import LossWeightSchedule
from fast_neural_style_transfer_tpu_torch.train.state import (
    create_train_state,
    is_reference_training_checkpoint,
    state_from_reference_checkpoint,
)
from fast_neural_style_transfer_tpu_torch.train.spatial_step import make_spatial_train_step
from fast_neural_style_transfer_tpu_torch.train.step import (
    make_eval_forward,
    make_train_step,
)
from fast_neural_style_transfer_tpu_torch.utils.image_io import load_image, save_image
from fast_neural_style_transfer_tpu_torch.utils.logging import MetricLogger
from fast_neural_style_transfer_tpu_torch.utils.visualization import plot_after_training


@dataclasses.dataclass
class TrainConfig:
    """The JAX package's ``TrainConfig`` fields, plus ``device`` (None: the
    card)."""

    style_image: Union[str, Tuple[str, ...]]
    dataset_dir: str
    output_dir: str = "training_output"
    vgg_weights: Optional[str] = None
    monitor_image: Optional[str] = None

    total_steps: int = 80_000
    num_epochs: Optional[int] = None
    batch_size: int = 20
    lr: float = 1e-3
    image_size: Tuple[int, int] = (256, 256)

    content_weight: float = 1000.0
    style_weight: float = 1.0
    tv_weight: float = 10.0
    weight_decay_every: int = 10_000
    grad_accum: int = 1
    pad_batch: bool = False
    remat: bool = False
    in_stats: str = "stable"

    content_tap: str = "relu4_2"
    style_taps: Tuple[str, ...] = ("relu1_2", "relu2_2", "relu3_3")
    style_tap_weights: Tuple[float, ...] = (0.25, 0.3, 0.45)

    precision: str = "f32"
    seed: int = 0
    num_workers: int = 8
    spatial: int = 1

    log_every: int = 100
    monitor_every: int = 1000
    checkpoint_every: int = 5000
    resume: bool = True
    max_checkpoints: int = 3
    init_checkpoint: Optional[str] = None

    profile_start: int = 0
    profile_stop: int = 0

    device: Optional[str] = None


def _check_config(cfg: TrainConfig) -> None:
    if cfg.image_size[0] % 4 or cfg.image_size[1] % 4:
        raise ValueError(
            f"image_size {cfg.image_size} must be a multiple of 4 in both "
            "dims (stylizer downsamples 4x and upsamples back)")
    if cfg.in_stats not in ("stable", "onepass"):
        raise ValueError(f"unknown in_stats {cfg.in_stats!r}")
    if cfg.spatial > 1:
        if cfg.in_stats == "onepass":
            raise ValueError("in_stats='onepass' is not supported with spatial "
                             "sharding (spatial > 1)")
        if cfg.image_size[0] % (8 * cfg.spatial):
            raise ValueError(
                f"image height {cfg.image_size[0]} must divide 8 * spatial "
                f"({8 * cfg.spatial}): stylizer needs 4, VGG's pools need 8 rows "
                "per shard")
        if not isinstance(cfg.style_image, str) and len(cfg.style_image) > 1:
            raise ValueError("multi-style training and --spatial height sharding "
                             "cannot be combined yet (the halo-exchange step is "
                             "single-style)")
        if cfg.pad_batch:
            raise ValueError("--pad_batch is not supported with --spatial height "
                             "sharding (the halo-exchange step has no batch-mask "
                             "plumbing)")


def _train_rank(plan, cfg: TrainConfig) -> str:
    return train_style_transfer(cfg, plan)


def num_ranks(device, spatial: int = 1) -> int:
    """The ranks a run on ``device`` spawns: a rank a card when ``device``
    is None or "cuda" and the cards (more than one) divide by ``spatial``,
    else ``spatial`` (1: this process alone)."""
    device = resolve_device(device)
    cards = (torch.cuda.device_count() if device.type == "cuda" and device.index is None
             else 1)
    return cards if cards > 1 and cards % spatial == 0 else spatial


def train_style_transfer(cfg: TrainConfig, plan=None) -> str:
    """Run training; returns the path of the final params artifact.
    ``plan``: this rank's ``MeshPlan``; None spawns the ranks (on
    ``cfg.device``, ``num_ranks``) and returns rank 0's path, or trains in
    this process when that is one rank."""
    _check_config(cfg)
    style_paths = ([cfg.style_image] if isinstance(cfg.style_image, str)
                   else list(cfg.style_image))
    styles = len(style_paths)
    ranks = num_ranks(cfg.device, cfg.spatial) if plan is None else 1
    if ranks > 1:
        from fast_neural_style_transfer_tpu_torch.parallel import launch

        return launch(_train_rank, ranks, (cfg,), spatial=cfg.spatial,
                      device=resolve_device(cfg.device).type,
                      deadline_s=float("inf"))[0]
    if plan is not None and plan.spatial != cfg.spatial:
        raise ValueError(f"spatial={cfg.spatial} but the plan has {plan.spatial} ranks")
    spatial = plan is not None and cfg.spatial > 1
    data = plan.data if plan is not None else None
    shards = plan.num_data_shards if plan is not None else 1
    device = plan.device if plan is not None else resolve_device(cfg.device)
    lead = plan is None or plan.lead
    say = print if lead else (lambda *a, **k: None)
    if plan is not None:
        plan.check_batch(cfg.batch_size)
    os.makedirs(cfg.output_dir, exist_ok=True)
    prec = canonical_compute_dtype(cfg.precision)
    exact_f32(device, prec)
    taps = LossTaps(style_taps=tuple(cfg.style_taps),
                    style_weights=tuple(cfg.style_tap_weights),
                    content_tap=cfg.content_tap)
    say(f"device: {device}"
        + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else "")
        + f"; batch {cfg.batch_size}; precision {cfg.precision}"
        + (f"; rows split over {cfg.spatial} ranks ({plan.backend})" if spatial else "")
        + (f"; batch split over {shards} ranks ({plan.backend})" if shards > 1 else ""),
        flush=True)
    say((plan or ReplicaPlan((device,))).describe(cfg.batch_size), flush=True)

    # frozen VGG19 and the style targets, once
    vgg = make_vgg(resolve_params(cfg.vgg_weights, seed=cfg.seed), device)
    per_style = []
    for path in style_paths:
        style = torch.from_numpy(load_image(path, cfg.image_size)).to(device)
        with torch.no_grad():
            per_style.append([g.detach() for g in style_targets_from_features(
                vgg(style, taps.style_taps, precision=prec))])
    if styles == 1:
        style_grams = per_style[0]
    else:  # per-layer (S, c, c) banks for the per-example selection
        style_grams = [torch.stack(layer) for layer in zip(*per_style)]
        say(f"multi-style run: {styles} styles via conditional IN", flush=True)

    torch.manual_seed(cfg.seed)  # PyTorch-default init of the stylizer
    net = TransformerNet(num_styles=styles)
    # a reference training .pth resumes fully; any other file warm-starts
    full_resume = bool(cfg.init_checkpoint) and is_reference_training_checkpoint(
        cfg.init_checkpoint)
    if full_resume and styles > 1:
        raise ValueError(
            f"cannot resume a reference training checkpoint into a {styles}-style "
            "run: reference checkpoints are single-style")
    if cfg.init_checkpoint and not full_resume:
        loaded = load_checkpoint(cfg.init_checkpoint)
        if num_styles(loaded) != styles:
            raise ValueError(
                f"init_checkpoint has {num_styles(loaded)} style(s) but this run "
                f"trains {styles} — style counts must match to warm-start")
        net.load_state_dict(loaded, strict=True)
        say(f"warm-started params from {cfg.init_checkpoint}", flush=True)
    net = net.to(device, memory_format=torch.channels_last)
    if full_resume:
        state = state_from_reference_checkpoint(
            cfg.init_checkpoint, net, cfg.lr, cfg.total_steps, grad_accum=cfg.grad_accum)
        say(f"fully resumed reference training checkpoint {cfg.init_checkpoint} "
            f"at iteration {state.step}", flush=True)
    else:
        state = create_train_state(net, cfg.lr, cfg.total_steps, grad_accum=cfg.grad_accum)

    ckpt = CheckpointManager(os.path.join(cfg.output_dir, "checkpoints"),
                             max_to_keep=cfg.max_checkpoints)
    resume_label = None
    if cfg.resume and ckpt.latest_step() is not None:
        resume_label = ckpt.latest_step()
        state.load_state_dict(ckpt.restore(resume_label))
        say(f"resumed from checkpoint {resume_label} (optimizer step "
            f"{state.step})", flush=True)

    schedule = LossWeightSchedule(
        content=cfg.content_weight, style=cfg.style_weight,
        tv=cfg.tv_weight, decay_every=cfg.weight_decay_every)
    if spatial:
        spatial_step = make_spatial_train_step(
            plan, taps=taps, weight_schedule=schedule, precision=prec, lr=cfg.lr,
            total_steps=cfg.total_steps, grad_accum=cfg.grad_accum, remat=cfg.remat)

        def train_step(state, vgg, batch, style_grams, generator, batch_mask=None):
            return spatial_step(state, vgg, batch, style_grams, generator)
    else:
        train_step = make_train_step(
            taps=taps, weight_schedule=schedule,
            precision=prec, lr=cfg.lr, total_steps=cfg.total_steps,
            grad_accum=cfg.grad_accum, remat=cfg.remat, num_styles=styles,
            norm_method="onepass" if cfg.in_stats == "onepass" else "auto",
            data=data)
    eval_forward = make_eval_forward(precision=prec)

    dataset = ImageFolderDataset(cfg.dataset_dir, cfg.image_size, seed=cfg.seed)
    pipeline = InputPipeline(dataset, cfg.batch_size, seed=cfg.seed,
                             num_workers=cfg.num_workers,
                             pad_to_multiple=8 if cfg.pad_batch else 0,
                             num_data_shards=shards,
                             shard_index=data.index if data is not None else 0,
                             device=device)
    batch_mask = None
    if pipeline.batch_mask is not None:
        batch_mask = torch.from_numpy(pipeline.batch_mask).to(device)
        say(f"pad_batch: per-rank batch {pipeline.local_batch_size} -> "
            f"{pipeline.padded_size} (loss-masked padding; gradients are the real "
            "batch's)", flush=True)

    monitor_img = None
    if cfg.monitor_image and lead:
        if os.path.exists(cfg.monitor_image):
            monitor_img = torch.from_numpy(load_image(cfg.monitor_image, cfg.image_size)).to(device)
        else:
            say(f"monitor image {cfg.monitor_image} not found; skipping "
                "monitor sampling", flush=True)

    logger = MetricLogger(os.path.join(cfg.output_dir, "metrics.jsonl") if lead else None,
                          print_every=cfg.log_every)
    # dropout masks: a generator per data index (the space ranks of one
    # sample share its masks)
    generator = torch.Generator(device=device).manual_seed(
        cfg.seed + 1 + 7919 * (data.index if data is not None else 0))
    start_step = state.step if resume_label is None else resume_label
    t_start = time.perf_counter()

    stop_requested = threading.Event()
    handler_installed = False
    prev_handler = None
    if threading.current_thread() is threading.main_thread():
        def _on_sigterm(signum, frame):
            say("SIGTERM received: checkpointing and stopping", flush=True)
            stop_requested.set()

        prev_handler = signal.signal(signal.SIGTERM, _on_sigterm)
        handler_installed = True

    profiler = None
    step = start_step
    try:
        for batch in pipeline.device_batches(cfg.num_epochs):
            stop = stop_requested.is_set()
            if plan is not None:  # every rank stops at the same step, or the others hang
                stop = plan.world.any(stop, device)
            if step >= cfg.total_steps or stop:
                break
            if cfg.profile_stop > cfg.profile_start:
                if step == cfg.profile_start and profiler is None:
                    profiler = torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CPU,
                        *([torch.profiler.ProfilerActivity.CUDA]
                          if device.type == "cuda" else [])])
                    profiler.start()
                elif step == cfg.profile_stop and profiler is not None:
                    _stop_profiler(profiler, cfg.output_dir)
                    profiler = None
            metrics = train_step(state, vgg, batch, style_grams, generator,
                                 batch_mask=batch_mask)
            step += 1
            if lead:
                logger.update(metrics)
            if logger.should_log(step):
                logger.flush(step)
            if monitor_img is not None and step % cfg.monitor_every == 0:
                _monitor_samples(state.net, eval_forward, monitor_img,
                                 cfg.output_dir, step)
            if step % cfg.checkpoint_every == 0 and lead:
                ckpt.save(step, state.state_dict())
                print(f"checkpoint saved at step {step}", flush=True)
    finally:
        # each cleanup step is isolated, so a failure in one (a device
        # fault surfacing in the metrics fetch) neither masks the original
        # exception nor skips the checkpoint behind it
        def _cleanup(what, fn):
            try:
                fn()
            except Exception as e:
                print(f"cleanup: {what} failed: {e!r}", flush=True)

        if profiler is not None:
            _cleanup("profiler stop", lambda: _stop_profiler(profiler, cfg.output_dir))
        if logger.pending:
            _cleanup("metrics flush", lambda: logger.flush(step))
        if step > start_step and ckpt.latest_step() != step and lead:
            _cleanup("final checkpoint", lambda: ckpt.save(step, state.state_dict()))
        _cleanup("logger close", logger.close)
        if handler_installed:
            signal.signal(signal.SIGTERM, prev_handler or signal.SIG_DFL)

    wall = time.perf_counter() - t_start
    done = step - start_step
    if done:
        say(f"trained {done} steps in {wall:.1f}s ({done / wall:.2f} steps/s)",
            flush=True)
    final_path = os.path.join(cfg.output_dir, "style_transfer_final.npz")
    if lead:
        save_params_npz(state.net.state_dict(), final_path)
        print(f"final params saved to {final_path}", flush=True)
        plot_after_training(cfg.output_dir)
    return final_path


def _monitor_samples(net, eval_forward, img, output_dir: str, step: int) -> None:
    """One monitor sample, or one per style through ``bake_style`` (a
    single-style copy of the net for each)."""
    styles = net.num_styles
    if styles == 1:
        path = os.path.join(output_dir, f"sample_step_{step}.jpg")
        save_image(eval_forward(net, img).float().cpu().numpy(), path)
        print(f"saved monitor sample {path}", flush=True)
        return
    params = net.state_dict()
    for s in range(styles):
        baked = TransformerNet()
        baked.load_state_dict(bake_style(params, s), strict=True)
        baked = baked.to(img.device, memory_format=torch.channels_last)
        out = eval_forward(baked, img)
        save_image(out.float().cpu().numpy(),
                   os.path.join(output_dir, f"sample_step_{step}_style{s}.jpg"))
    print(f"saved {styles} monitor samples at step {step}", flush=True)


def _stop_profiler(profiler, output_dir: str) -> None:
    profiler.stop()
    os.makedirs(os.path.join(output_dir, "profile"), exist_ok=True)
    profiler.export_chrome_trace(os.path.join(output_dir, "profile", "trace.json"))
