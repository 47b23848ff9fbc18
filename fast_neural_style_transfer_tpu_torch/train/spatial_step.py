"""Height-sharded training: the whole train step with each image's rows
split over ranks (the JAX package's ``train/spatial_step.py``).

For high-resolution fine-tuning (512^2 to 4K), where one card cannot hold
the activations. Everything that crosses H is sharding-aware
(``models/spatial.py``, ``ops/sharded.py``): the stylizer and VGG convs
exchange halos, the instance norms take their statistics over the whole
image, every loss sum runs over the ranks and TV adds its seams. The loss,
and so the gradient, equals the unsharded step's to rounding
(``tests/test_torch_spatial_train.py``).

The gradient: every rank holds the same global loss and backpropagates it
through its own slab. The loss's cross-rank sums have an identity backward
(``SpaceAxis.psum``), a halo exchange sends its gradient back to the rank
that sent the rows, and the sharded instance norm sums its gradient sums
over the ranks inside its backward but returns only this rank's dgamma and
dbeta. So each rank ends with its share of every parameter gradient, and
one all_reduce (sum) over the 'space' group makes the true gradient, the
same on every rank; then the optimizer steps alike everywhere. (The JAX
package's shard_map transposes psums into psums; its own note on that trap
is at its ``train/spatial_step.py:168-174``.)

On a 2-D (data x space) mesh each space group holds its own samples: the
content and TV sums span both axes, each style layer's over-batch sum the
data axis, TV divides by the global batch (``batch_axes``, as the JAX
package's), and the gradient shares are summed over every rank at once.
Dropout masks come from a generator seeded per data index: the space
ranks of one sample share its mask.

Local H per rank: divisible by 8 (the stylizer needs 4, VGG's three pools
before relu4_3 need 8).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from fast_neural_style_transfer_tpu_torch.core.dtypes import Precision, exact_f32
from fast_neural_style_transfer_tpu_torch.losses import LossTaps
from fast_neural_style_transfer_tpu_torch.models.spatial import (
    transformer_forward_sharded,
    vgg_features_sharded,
)
from fast_neural_style_transfer_tpu_torch.ops import sharded as sh
from fast_neural_style_transfer_tpu_torch.train.schedule import (
    LossWeightSchedule,
    cosine_lr_schedule,
)
from fast_neural_style_transfer_tpu_torch.train.state import TrainState, global_norm
from fast_neural_style_transfer_tpu_torch.train.step import (
    ACTIVATION_CLAMP,
    all_reduce_grads,
    normalize_u8_batch,
)


def spatial_loss_fn(
    net: torch.nn.Module,
    vgg: torch.nn.Module,
    batch: torch.Tensor,
    style_grams: Sequence[torch.Tensor],
    weights: Tuple[float, float, float],
    *,
    axis,
    taps: LossTaps,
    precision: Precision,
    generator: Optional[torch.Generator] = None,
    dropout: bool = True,
    remat: bool = False,
    batch_axes: Tuple = (),
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """This rank's slab ``batch`` (NHWC) -> the weighted perceptual loss of
    the whole batch, the same on every rank, and its metrics. Every sum runs
    over the ranks (over ``batch_axes`` too: the axes the batch is split
    over). Dropout masks come from ``generator``, seeded alike on
    every rank: the ranks of one sample share its mask. ``remat``:
    recompute the stylizer and the stylized-branch VGG in the backward
    (their exchanges run again there, on every rank alike); the generator is
    rewound for the recomputation."""
    cw, sw, tw = weights
    batch = normalize_u8_batch(batch)
    tap_names = taps.all_taps
    gen_state = generator.get_state() if (remat and generator is not None) else None

    def net_fwd(b):
        if gen_state is not None:
            generator.set_state(gen_state)
        out = transformer_forward_sharded(net, b, axis=axis, precision=precision,
                                          generator=generator, dropout=dropout)
        return torch.clamp(out, -ACTIVATION_CLAMP, ACTIVATION_CLAMP)

    def vgg_fwd(s):
        return tuple(vgg_features_sharded(vgg, s, tap_names, axis=axis,
                                          precision=precision))

    stylized = (checkpoint(net_fwd, batch, use_reentrant=False) if remat
                else net_fwd(batch))
    with torch.no_grad():
        content_feats = vgg_fwd(batch)
    stylized_feats = (checkpoint(vgg_fwd, stylized, use_reentrant=False) if remat
                      else vgg_fwd(stylized))
    s_feats, c_stylized = taps.split(stylized_feats)
    _, c_target = taps.split(content_feats)

    c_loss = cw * sh.content_loss_sharded(c_stylized, c_target, axis, batch_axes)
    s_total = None
    for feat, tgt, w in zip(s_feats, style_grams, taps.style_weights):
        c = tgt.shape[-1]
        g = sh.gram_matrix_sharded(feat, axis)
        layer = sh.psum_over(torch.sum(torch.square(g - tgt.float()[None])), batch_axes)
        term = (w * layer) / (c * c)
        s_total = term if s_total is None else s_total + term
    s_loss = sw * s_total
    t_loss = tw * sh.total_variation_loss_sharded(stylized, axis, batch_axes)
    total = c_loss + s_loss + t_loss
    metrics = {"loss": total.detach(), "content_loss": c_loss.detach(),
               "style_loss": s_loss.detach(), "tv_loss": t_loss.detach()}
    return total, metrics


def shard_rows(batch: torch.Tensor, axis) -> torch.Tensor:
    """This rank's rows of an NHWC batch (H divisible by 8 * ranks)."""
    h = batch.shape[1]
    if h % (8 * axis.size):
        raise ValueError(f"image height {h} must divide 8 * spatial ({8 * axis.size}): "
                         "the stylizer needs 4, VGG's pools need 8 rows per shard")
    local = h // axis.size
    return batch[:, axis.index * local:(axis.index + 1) * local].contiguous()


def make_spatial_train_step(
    plan,
    *,
    taps: LossTaps = LossTaps(),
    weight_schedule: LossWeightSchedule = LossWeightSchedule(),
    precision: Precision = Precision.f32(),
    lr: float = 1e-3,
    total_steps: int = 80_000,
    grad_accum: int = 1,
    remat: bool = False,
    dropout: bool = True,
) -> Callable:
    """Build ``step(state, vgg, batch, style_grams, generator=None) ->
    metrics``, which updates ``state`` in place on every rank of ``plan``.
    ``batch`` is this data shard's NHWC batch (the same on every rank of a
    space group; each rank takes its rows). The step unit is
    ``make_train_step``'s: schedules are functions of applied updates
    (``state.step // grad_accum``). A non-finite global loss skips the
    update on every rank alike."""
    axis = plan.space
    batch_axes = (plan.data,) if plan.data.size > 1 else ()
    lr_schedule = cosine_lr_schedule(lr, max(total_steps // grad_accum, 1))

    def step_fn(state: TrainState, vgg, batch: torch.Tensor, style_grams,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        exact_f32(batch.device, precision)
        applied_step = state.step // grad_accum
        local = shard_rows(batch, axis)
        state.net.train()
        params = list(state.net.parameters())
        total, metrics = spatial_loss_fn(
            state.net, vgg, local, style_grams, weight_schedule(applied_step),
            axis=axis, taps=taps, precision=precision, generator=generator,
            dropout=dropout, remat=remat, batch_axes=batch_axes)
        grads = all_reduce_grads(torch.autograd.grad(total, params), plan.world)
        finite = bool(torch.isfinite(total))  # the global loss: alike on every rank
        if finite:
            state.optimizer.update(grads)
            state.step += 1
        dev = total.device
        metrics["grad_norm"] = global_norm(grads)
        metrics["lr"] = torch.tensor(lr_schedule(applied_step), device=dev)
        metrics["skipped_nonfinite"] = torch.tensor(0.0 if finite else 1.0, device=dev)
        return metrics

    return step_fn
