"""AdaIN decoder training: the step and the loop (the JAX package's
``train/adain.py``).

Trains the arbitrary-style decoder (``models/adain.py``) as Huang &
Belongie 2017 §6 do: content and style batches stream independently, each
step pairs them, and the loss is

    L = ||f(g(t)) - t||^2 + lambda * sum_taps (||mu - mu_s||^2 + ||sigma - sigma_s||^2)

with f the frozen VGG19 to relu4_1, t = AdaIN(f(content), f(style)), g the
decoder, the statistics over relu1_1..relu4_1, mean-MSE reductions, Adam at
lr 1e-4 with no clip. The inverse-time decay ``1 / (1 + decay * step)`` is
the lr of the Adam param group, set before each update from the count of
updates applied (Adam's step is proportional to its lr, so this equals the
JAX package's scaling of the updates). A non-finite loss applies no update
and does not advance the count.

Data parallelism: as the JAX trainer builds its mesh over every device
(``make_mesh_plan()``, ``check_batch``) and shards both streams, the port
spawns a rank a card when there are several (``train_adain``), each rank
decoding its slice of both global batches. Every loss term here is a mean
over the batch, so the ranks' gradients are AVERAGED (summed in one
all_reduce, then divided by the data degree), and so are the metrics:
the opposite of the stylizer's rule (``train/step.py``), whose terms are
sums.

On the card ``adain`` runs the IN forward kernel (t needs no gradient: it
is the decoder's input), and the encode of the decoder's output takes its
input gradient through VGG conv1_1's hand-written kernel
(``ops/cuda_conv.py``, the tap-packed route). ``remat`` recomputes the
decoder and that encode in the backward (``torch.utils.checkpoint``).
"""

from __future__ import annotations

import dataclasses
import os
import signal
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from fast_neural_style_transfer_tpu_torch.core.dtypes import (
    Precision,
    canonical_compute_dtype,
    exact_f32,
)
from fast_neural_style_transfer_tpu_torch.models.adain import (
    STYLE_TAPS,
    AdaINDecoder,
    adain,
    channel_stats,
)
from fast_neural_style_transfer_tpu_torch.train.state import global_norm
from fast_neural_style_transfer_tpu_torch.train.step import (
    all_reduce_grads,
    all_reduce_metrics,
    normalize_u8_batch,
)


def adain_loss_fn(
    decoder: AdaINDecoder,
    vgg: torch.nn.Module,
    content: torch.Tensor,
    style: torch.Tensor,
    style_weight: float,
    *,
    precision: Precision,
    remat: bool = False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total, metrics) for one (content batch, style batch) pair, uint8 or
    network-space NHWC. Only the decoder's output carries a gradient: the
    content and style encodes and t run without one."""
    content = normalize_u8_batch(content)
    style = normalize_u8_batch(style)
    with torch.no_grad():
        (c_feat,) = vgg(content, (STYLE_TAPS[-1],), precision=precision)
        s_feats = vgg(style, STYLE_TAPS, precision=precision)
        t = adain(c_feat, s_feats[-1])

    def dec_fwd(v):
        return decoder(v, precision)

    def enc_fwd(v):
        return tuple(vgg(v, STYLE_TAPS, precision=precision))

    if remat:
        img = checkpoint(dec_fwd, t, use_reentrant=False)
        o_feats = checkpoint(enc_fwd, img, use_reentrant=False)
    else:
        img = dec_fwd(t)
        o_feats = enc_fwd(img)

    # content: mean-MSE against the AdaIN target (paper eq. 12)
    c_loss = torch.mean(torch.square(o_feats[-1].float() - t.float()))
    # style: channel mean/std alignment at every tap (paper eq. 13)
    s_loss = torch.zeros((), device=img.device)
    for o, s in zip(o_feats, s_feats):
        mu_o, sd_o = channel_stats(o)
        mu_s, sd_s = channel_stats(s)
        s_loss = s_loss + torch.mean(torch.square(mu_o - mu_s))
        s_loss = s_loss + torch.mean(torch.square(sd_o - sd_s))
    total = c_loss + style_weight * s_loss
    return total, {"loss": total.detach(), "content_loss": c_loss.detach(),
                   "style_loss": s_loss.detach()}


def lr_decay_factor(decay: float, step: int) -> float:
    """The AdaIN paper's inverse-time decay as a factor on the base lr:
    ``1 / (1 + decay * step)``, ``step`` the count of applied updates; 0
    decay is a constant lr."""
    return 1.0 / (1.0 + decay * step)


@dataclasses.dataclass
class AdaINTrainState:
    """The decoder, its Adam and the count of applied updates."""

    decoder: AdaINDecoder
    optimizer: torch.optim.Adam
    step: int = 0

    def state_dict(self) -> Dict[str, Any]:
        return {"decoder": self.decoder.state_dict(),
                "optimizer": self.optimizer.state_dict(), "step": self.step}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.decoder.load_state_dict(sd["decoder"])
        self.optimizer.load_state_dict(sd["optimizer"])
        self.step = int(sd["step"])


def create_adain_train_state(decoder: AdaINDecoder, lr: float = 1e-4) -> AdaINTrainState:
    """Adam(0.9, 0.999, eps 1e-8) over the decoder, optax.adam's defaults."""
    opt = torch.optim.Adam(decoder.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    return AdaINTrainState(decoder=decoder, optimizer=opt)


def make_adain_train_step(
    *,
    lr: float = 1e-4,
    style_weight: float = 10.0,
    precision: Precision = Precision.f32(),
    lr_decay: float = 0.0,
    remat: bool = False,
    data=None,
) -> Callable:
    """``step(state, vgg, content, style) -> metrics``, which updates
    ``state`` in place: gradients, then (if the loss is finite) one Adam
    update at lr * ``lr_decay_factor(lr_decay, state.step)`` and step + 1;
    a non-finite loss leaves params, moments and step as they were.
    ``lr`` must be the optimizer's base lr. ``data``: the plan's
    ``DataAxis``; ``content`` and ``style`` are then this rank's slices,
    and the gradients and metrics are averaged over the ranks (every term
    is a mean; module docstring)."""
    dp = data is not None and data.size > 1

    def step_fn(state: AdaINTrainState, vgg, content: torch.Tensor,
                style: torch.Tensor) -> Dict[str, torch.Tensor]:
        exact_f32(content.device, precision)
        params = list(state.decoder.parameters())
        total, metrics = adain_loss_fn(state.decoder, vgg, content, style,
                                       style_weight, precision=precision, remat=remat)
        grads = torch.autograd.grad(total, params)
        if dp:
            grads = [g / data.size for g in all_reduce_grads(grads, data)]
            metrics = all_reduce_metrics(metrics, data, mean=True)
        finite = bool(torch.isfinite(metrics["loss"]))  # global: alike on every rank
        if finite:
            for group in state.optimizer.param_groups:
                group["lr"] = lr * lr_decay_factor(lr_decay, state.step)
            for p, g in zip(params, grads):
                p.grad = g
            state.optimizer.step()
            for p in params:
                p.grad = None
            state.step += 1
        dev = total.device
        metrics["grad_norm"] = global_norm(grads)
        metrics["skipped_nonfinite"] = torch.tensor(0.0 if finite else 1.0, device=dev)
        return metrics

    return step_fn


@dataclasses.dataclass
class AdaINTrainConfig:
    """The JAX package's ``AdaINTrainConfig``, plus ``device`` (None: the
    card)."""

    content_dir: str
    style_dir: str
    output_dir: str = "adain_output"
    vgg_weights: Optional[str] = None

    total_steps: int = 20_000
    batch_size: int = 8
    lr: float = 1e-4
    lr_decay: float = 5e-5
    style_weight: float = 10.0
    remat: bool = False
    image_size: Tuple[int, int] = (256, 256)
    precision: str = "f32"
    seed: int = 0
    num_workers: int = 8

    log_every: int = 100
    checkpoint_every: int = 2000
    resume: bool = True
    max_checkpoints: int = 3

    device: Optional[str] = None


def _adain_rank(plan, cfg: AdaINTrainConfig) -> str:
    return train_adain(cfg, plan)


def train_adain(cfg: AdaINTrainConfig, plan=None) -> str:
    """Train the arbitrary-style decoder; returns the final ``.npz`` path
    (``adain_decoder_final.npz``, the JAX package's layout). Checkpoints
    (decoder, Adam, step) go to ``<output_dir>/checkpoints`` and a rerun
    resumes from the latest; SIGTERM finishes the step in flight and
    checkpoints. ``plan``: this rank's ``MeshPlan`` (a data axis only);
    None spawns a rank a card when ``cfg.device`` is None or "cuda" and
    there are several cards (``train/loop.py::num_ranks``), else trains in
    this process. Rank 0 alone prints, logs and writes files, the
loss-curve PNGs last (``utils/visualization.py``)."""
    from fast_neural_style_transfer_tpu_torch.core.shapes import resolve_device
    from fast_neural_style_transfer_tpu_torch.data import ImageFolderDataset, InputPipeline
    from fast_neural_style_transfer_tpu_torch.models.adain import make_decoder, save_decoder_npz
    from fast_neural_style_transfer_tpu_torch.models.vgg_weights import make_vgg, resolve_params
    from fast_neural_style_transfer_tpu_torch.train.checkpoint import CheckpointManager
    from fast_neural_style_transfer_tpu_torch.train.loop import num_ranks
    from fast_neural_style_transfer_tpu_torch.utils.logging import MetricLogger
    from fast_neural_style_transfer_tpu_torch.utils.visualization import plot_after_training

    if cfg.image_size[0] % 8 or cfg.image_size[1] % 8:
        raise ValueError(
            f"image_size {cfg.image_size} must be a multiple of 8 (three VGG "
            "pools down, three x2 decoder ups back)")
    ranks = num_ranks(cfg.device) if plan is None else 1
    if ranks > 1:
        from fast_neural_style_transfer_tpu_torch.parallel import launch

        return launch(_adain_rank, ranks, (cfg,), spatial=1,
                      device=resolve_device(cfg.device).type,
                      deadline_s=float("inf"))[0]
    if plan is not None and plan.spatial != 1:
        raise ValueError("the AdaIN trainer splits the batch only (a plan with spatial 1)")
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
    say(f"device: {device}"
        + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else "")
        + f"; batch {cfg.batch_size}; precision {cfg.precision}"
        + (f"; batch split over {shards} ranks ({plan.backend})" if shards > 1 else ""),
        flush=True)

    vgg = make_vgg(resolve_params(cfg.vgg_weights, seed=cfg.seed), device)
    torch.manual_seed(cfg.seed)  # PyTorch-default init of the decoder
    state = create_adain_train_state(make_decoder(None, device), cfg.lr)

    ckpt = CheckpointManager(os.path.join(cfg.output_dir, "checkpoints"),
                             max_to_keep=cfg.max_checkpoints)
    # the loop counter resumes from the label, which also counts skipped
    # non-finite steps (state.step does not)
    resume_label = None
    if cfg.resume and ckpt.latest_step() is not None:
        resume_label = ckpt.latest_step()
        state.load_state_dict(ckpt.restore(resume_label))
        say(f"resumed AdaIN decoder from checkpoint {resume_label} "
            f"(optimizer step {state.step})", flush=True)

    step_fn = make_adain_train_step(lr=cfg.lr, lr_decay=cfg.lr_decay,
                                    style_weight=cfg.style_weight,
                                    precision=prec, remat=cfg.remat, data=data)
    # two independent streams; different seeds decorrelate the pairing
    shard = {"num_data_shards": shards, "shard_index": data.index if data is not None else 0}
    content_pipe = InputPipeline(
        ImageFolderDataset(cfg.content_dir, cfg.image_size, seed=cfg.seed),
        cfg.batch_size, seed=cfg.seed, num_workers=cfg.num_workers, device=device,
        **shard)
    style_pipe = InputPipeline(
        ImageFolderDataset(cfg.style_dir, cfg.image_size, seed=cfg.seed + 7),
        cfg.batch_size, seed=cfg.seed + 7, num_workers=cfg.num_workers, device=device,
        **shard)

    logger = MetricLogger(os.path.join(cfg.output_dir, "metrics.jsonl") if lead else None,
                          print_every=cfg.log_every)
    start = state.step if resume_label is None else resume_label
    n = start
    t0 = time.perf_counter()

    stop_requested = threading.Event()
    handler_installed = False
    prev_handler = None
    if threading.current_thread() is threading.main_thread():
        def _on_sigterm(signum, frame):
            say("SIGTERM received: checkpointing and stopping", flush=True)
            stop_requested.set()

        prev_handler = signal.signal(signal.SIGTERM, _on_sigterm)
        handler_installed = True

    try:
        for content, style in zip(content_pipe.device_batches(),
                                  style_pipe.device_batches()):
            stop = stop_requested.is_set()
            if plan is not None:  # every rank stops at the same step
                stop = plan.world.any(stop, device)
            if n >= cfg.total_steps or stop:
                break
            metrics = step_fn(state, vgg, content, style)
            n += 1
            if lead:
                logger.update(metrics)
            if logger.should_log(n):
                logger.flush(n)
            if n % cfg.checkpoint_every == 0 and lead:
                ckpt.save(n, state.state_dict())
                print(f"AdaIN checkpoint saved at step {n}", flush=True)
    finally:
        # each cleanup step is isolated (train/loop.py)
        def _cleanup(what, fn):
            try:
                fn()
            except Exception as e:
                print(f"cleanup: {what} failed: {e!r}", flush=True)

        if logger.pending:
            _cleanup("metrics flush", lambda: logger.flush(n))
        if n > start and ckpt.latest_step() != n and lead:
            _cleanup("final checkpoint", lambda: ckpt.save(n, state.state_dict()))
        _cleanup("logger close", logger.close)
        if handler_installed:
            signal.signal(signal.SIGTERM, prev_handler or signal.SIG_DFL)

    wall = time.perf_counter() - t0
    done = n - start
    if done:
        say(f"AdaIN: trained {done} steps to step {n} in {wall:.1f}s "
            f"({done / wall:.2f} steps/s)", flush=True)
    final = os.path.join(cfg.output_dir, "adain_decoder_final.npz")
    if lead:
        save_decoder_npz(state.decoder.state_dict(), final)
        print(f"AdaIN decoder saved to {final}", flush=True)
        plot_after_training(cfg.output_dir, ("loss", "content_loss", "style_loss"))
    return final
