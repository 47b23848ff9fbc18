"""One training step: stylizer forward, two VGG passes, the losses, the
gradients and the update (the JAX package's ``train/step.py``).

Semantics kept from the JAX step:
- the stylized image is clamped to [-3, 3] before the losses;
- the content branch's VGG runs under ``no_grad``;
- the loss weights and the logged LR come from the applied-update count
  ``state.step // grad_accum``;
- a non-finite loss skips the update entirely: no gradient is accumulated,
  ``optimizer.step()`` is not called, and ``state.step`` holds. The check
  reads the loss on the host, one sync per step (the JAX step selects on the
  device instead);
- metrics ``loss``, ``content_loss``, ``style_loss``, ``tv_loss``,
  ``grad_norm``, ``lr``, ``skipped_nonfinite``;
- multi-style (``num_styles`` S > 1): each step draws one style index per
  example, one-hot (B, S), which conditions the stylizer's instance norms
  and picks each example's row of the (S, c, c) Gram banks. The draw comes
  from the step's ``torch.Generator`` (JAX's from its key: the two cannot
  match, so parity runs pass ``style_select`` in);
- ``norm_method="onepass"``: one-pass IN statistics in the stylizer (JAX
  ``norm_method="onepass"``).

Under a ``torch.profiler`` session the step records the spans
``train.loss`` (forward and losses enqueued), ``train.grad`` (the backward,
and the ranks' all_reduce), ``train.sync`` (the host's read of the loss)
and ``train.update`` (the optimizer and the logged metrics); see
``utils.tracing``.

Data parallelism (``data``, the plan's ``DataAxis``): each rank runs the
step on its slice of the global batch (its rows of ``style_select`` and
``batch_mask`` too). The JAX loss is not one mean: style and content are
sums over the batch and only TV divides by the batch count, so each rank
computes its style and content terms as they are and its TV over the
global count, and the ranks' gradients are SUMMED, in one all_reduce of
one flat buffer: averaging them, or summing the gradients of each rank's
own TV mean, would both be wrong. The metrics are the global ones (the
loss terms summed over the ranks, ``grad_norm`` of the summed
gradients), so the non-finite guard reads the same global loss on every
rank and every rank skips alike. Dropout masks come from each rank's own
generator (the loop seeds it by data index): they cannot match JAX's one
key over the global batch.

On the card the stylizer's 14 instance norms run the IN forward and
backward kernels and VGG conv1_1's input gradient the conv backward kernel.
In float32, TF32 is turned off for convolutions and matmuls
(``core/dtypes.py::exact_f32``, process-wide), so f32 means f32.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from fast_neural_style_transfer_tpu_torch.core.dtypes import Precision, exact_f32
from fast_neural_style_transfer_tpu_torch.losses import (
    LossTaps,
    content_loss,
    style_loss,
    total_variation_loss,
)
from fast_neural_style_transfer_tpu_torch.train.schedule import (
    LossWeightSchedule,
    cosine_lr_schedule,
)
from fast_neural_style_transfer_tpu_torch.train.state import TrainState, global_norm
from fast_neural_style_transfer_tpu_torch.utils import tracing
from fast_neural_style_transfer_tpu_torch.utils.image_io import u8_to_network

ACTIVATION_CLAMP = 3.0


def normalize_u8_batch(batch: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC -> network-space float32 on the batch's device; float
    input passes through."""
    if batch.dtype != torch.uint8:
        return batch
    return u8_to_network(batch)


def loss_fn(
    net: torch.nn.Module,
    vgg: torch.nn.Module,
    batch: torch.Tensor,
    style_grams: Sequence[torch.Tensor],
    weights: Tuple[float, float, float],
    *,
    taps: LossTaps,
    precision: Precision,
    generator: Optional[torch.Generator] = None,
    dropout: bool = True,
    remat: bool = False,
    batch_mask: Optional[torch.Tensor] = None,
    style_select: Optional[torch.Tensor] = None,
    norm_method: str = "auto",
    data=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Weighted perceptual loss of one batch -> (total, metrics).

    ``data`` (a ``DataAxis``): ``batch`` is this rank's slice, and the
    result is its share of the global batch's loss (TV over the global
    count; module docstring).

    ``style_select`` (multi-style only): (B, S) rows pairing each example
    with a style, for the stylizer's IN affines and the Gram banks alike.
    ``norm_method``: the stylizer's IN statistics, "auto" (stable) or
    "onepass".
    ``remat``: recompute the stylizer and the stylized-branch VGG in the
    backward (``torch.utils.checkpoint``) instead of keeping their
    activations; the dropout generator is rewound for the recomputation, so
    both passes draw the same masks."""
    cw, sw, tw = weights
    batch = normalize_u8_batch(batch)
    if batch_mask is not None and tuple(batch_mask.shape) != (batch.shape[0],):
        raise ValueError(
            f"batch_mask shape {tuple(batch_mask.shape)} != ({batch.shape[0]},)")
    tap_names = taps.all_taps
    gen_state = generator.get_state() if (remat and generator is not None) else None

    def net_fwd(b):
        if gen_state is not None:
            generator.set_state(gen_state)
        out = net(b, precision, generator=generator, dropout=dropout,
                  style_weights=style_select, norm_method=norm_method)
        return torch.clamp(out, -ACTIVATION_CLAMP, ACTIVATION_CLAMP)

    def vgg_fwd(s):
        return tuple(vgg(s, tap_names, precision=precision))

    if remat:
        stylized = checkpoint(net_fwd, batch, use_reentrant=False)
    else:
        stylized = net_fwd(batch)
    with torch.no_grad():
        content_feats = vgg(batch, tap_names, precision=precision)
    if remat:
        stylized_feats = checkpoint(vgg_fwd, stylized, use_reentrant=False)
    else:
        stylized_feats = vgg_fwd(stylized)

    s_feats, c_feat_stylized = taps.split(stylized_feats)
    _, c_feat_target = taps.split(content_feats)
    c_loss = cw * content_loss(c_feat_stylized, c_feat_target, batch_mask=batch_mask)
    s_loss = sw * style_loss(s_feats, style_grams, taps.style_weights,
                             style_select=style_select, batch_mask=batch_mask)
    t_loss = tw * total_variation_loss(stylized, batch_mask=batch_mask,
                                       batch_count=global_batch_count(batch, batch_mask, data))
    total = c_loss + s_loss + t_loss
    metrics = {"loss": total.detach(), "content_loss": c_loss.detach(),
               "style_loss": s_loss.detach(), "tv_loss": t_loss.detach()}
    return total, metrics


def global_batch_count(batch: torch.Tensor, batch_mask: Optional[torch.Tensor], data):
    """The examples of the global batch that TV's mean counts (the real
    ones under ``batch_mask``), or None without a data axis (the local
    batch's)."""
    if data is None or data.size == 1:
        return None
    if batch_mask is None:
        return float(batch.shape[0] * data.size)
    return data.all_reduce_(torch.sum(batch_mask.detach().float()))


def all_reduce_grads(grads: Sequence[torch.Tensor], axis) -> list:
    """Sum the ranks' gradient shares: one all_reduce of one flat buffer."""
    flat = torch.cat([g.reshape(-1) for g in grads])
    axis.all_reduce_(flat)
    out, at = [], 0
    for g in grads:
        out.append(flat[at:at + g.numel()].view_as(g))
        at += g.numel()
    return out


def all_reduce_metrics(metrics: Dict[str, torch.Tensor], axis, *,
                       mean: bool = False) -> Dict[str, torch.Tensor]:
    """The metrics summed (or averaged) over the ranks, in one all_reduce."""
    keys = list(metrics)
    v = axis.all_reduce_(torch.stack([metrics[k].float() for k in keys]))
    if mean:
        v = v / axis.size
    return dict(zip(keys, v.unbind()))


def make_train_step(
    *,
    taps: LossTaps = LossTaps(),
    weight_schedule: LossWeightSchedule = LossWeightSchedule(),
    precision: Precision = Precision.f32(),
    lr: float = 1e-3,
    total_steps: int = 80_000,
    grad_accum: int = 1,
    remat: bool = False,
    dropout: bool = True,
    num_styles: int = 1,
    norm_method: str = "auto",
    data=None,
) -> Callable:
    """Build ``step(state, vgg, batch, style_grams, generator=None,
    batch_mask=None, style_select=None) -> metrics``, which updates
    ``state`` in place. ``lr``, ``total_steps`` and ``grad_accum`` give the
    logged LR; they must be the optimizer's. With ``num_styles`` > 1 the
    step draws ``style_select`` from ``generator`` (one uniform index per
    example, one-hot) unless the caller passes one. ``data``: the plan's
    ``DataAxis``; ``batch`` (and ``batch_mask``, ``style_select``) are then
    this rank's slice, and the gradients are summed over the ranks before
    the update (module docstring)."""
    dp = data is not None and data.size > 1
    lr_schedule = cosine_lr_schedule(lr, max(total_steps // grad_accum, 1))

    def step_fn(state: TrainState, vgg, batch: torch.Tensor, style_grams,
                generator: Optional[torch.Generator] = None,
                batch_mask: Optional[torch.Tensor] = None,
                style_select: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        exact_f32(batch.device, precision)
        applied_step = state.step // grad_accum
        if num_styles > 1 and style_select is None:
            idx = torch.randint(0, num_styles, (batch.shape[0],),
                                generator=generator, device=batch.device)
            style_select = torch.nn.functional.one_hot(idx, num_styles).float()
        state.net.train()
        params = list(state.net.parameters())
        n = batch.shape[0]
        with tracing.span("train.loss", n=n):
            total, metrics = loss_fn(
                state.net, vgg, batch, style_grams, weight_schedule(applied_step),
                taps=taps, precision=precision, generator=generator,
                dropout=dropout, remat=remat, batch_mask=batch_mask,
                style_select=style_select, norm_method=norm_method, data=data)
        with tracing.span("train.grad", n=n):
            grads = torch.autograd.grad(total, params)
            if dp:
                grads = all_reduce_grads(grads, data)
                metrics = all_reduce_metrics(metrics, data)
        with tracing.span("train.sync", n=n):  # waits for the device
            finite = bool(torch.isfinite(metrics["loss"]))  # global: alike on every rank
        with tracing.span("train.update", n=n):
            if finite:
                state.optimizer.update(grads)
                state.step += 1
            dev = total.device
            metrics["grad_norm"] = global_norm(grads)
            metrics["lr"] = torch.tensor(lr_schedule(applied_step), device=dev)
            metrics["skipped_nonfinite"] = torch.tensor(0.0 if finite else 1.0, device=dev)
        return metrics

    return step_fn


def make_eval_forward(*, precision: Precision = Precision.f32()) -> Callable:
    """``fwd(net, x)``: the stylizer without dropout and without gradients
    (monitor samples)."""

    def fwd(net: torch.nn.Module, x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return net(x, precision, dropout=False)

    return fwd
