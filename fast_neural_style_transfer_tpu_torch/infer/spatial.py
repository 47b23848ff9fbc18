"""Height-sharded inference (the JAX package's ``infer/spatial.py``).

A large image (4K) is split by rows over the ranks of a ``MeshPlan``
(``parallel/mesh.py``); each rank runs the sharded stylizer forward on its
slab (``models/spatial.py``), exchanging only the convs' halo rows and the
instance norms' moments, and the slabs are gathered back: exact, not an
overlap-tile approximation. Every rank holds the whole input and gets the
whole output. The training counterpart is ``train/spatial_step.py``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fast_neural_style_transfer_tpu_torch.core.dtypes import Precision
from fast_neural_style_transfer_tpu_torch.core.shapes import pad_to_multiple_reflect
from fast_neural_style_transfer_tpu_torch.models.spatial import transformer_forward_sharded


def pad_rows(x: torch.Tensor, rows: int, mode: str) -> torch.Tensor:
    """Pad an NHWC batch's H at the bottom by ``rows``: "edge" repeats the
    last row, "zero" adds zeros."""
    if rows <= 0:
        return x
    xc = x.permute(0, 3, 1, 2)
    if mode == "edge":
        xc = F.pad(xc, (0, 0, 0, rows), mode="replicate")
    else:
        xc = F.pad(xc, (0, 0, 0, rows))
    return xc.permute(0, 2, 3, 1).contiguous()


def slab_heights(h: int, multiple: int, min_rows: int, shards: int) -> tuple:
    """(canonical H, slab-padded H): the single-device route's reflect pad
    to ``multiple`` (at least ``min_rows`` rows, by edge padding), then
    zero rows up to the equal-slab height, a multiple of multiple * shards
    with at least ``min_rows`` rows a shard."""
    hc = max(-(-h // multiple) * multiple, min_rows)
    mult = multiple * shards
    return hc, max(-(-hc // mult) * mult, min_rows * shards)


def gather_rows(slab: torch.Tensor, axis) -> torch.Tensor:
    """Every rank's NHWC slab, stacked back along H, on every rank."""
    parts = axis.gather(slab.contiguous())
    return torch.cat(list(parts), dim=1)


def stylize_spatial(
    net: nn.Module,
    image: torch.Tensor,
    plan,
    *,
    precision: Precision = Precision.f32(),
) -> torch.Tensor:
    """Stylize a network-space NHWC batch (the same on every rank, on the
    rank's device) with its rows split over ``plan``'s ranks -> the NHWC
    output, image's shape, on every rank.

    It matches the single-device route (reflect-pad to a multiple of 4,
    run, crop) to f32 rounding at any size. Stage 1 is that exact pad (at
    least 8 rows: the k9 conv's reflection needs 5); stage 2 zero-fills to
    the equal-slab height (a multiple of 4 * ranks, >= 8 rows a rank), and
    the forward's extent machinery (``models/spatial.py``) pins reflect
    boundary rows, masks the IN moments and zeroes the transpose convs'
    boundary row, so the fill never enters the math."""
    axis = plan.space
    n, h, w, c = image.shape
    x, _ = pad_to_multiple_reflect(image, 4)
    x = pad_rows(x, 8 - x.shape[1], "edge")
    h4, target_h = slab_heights(x.shape[1], 4, 8, axis.size)
    x = pad_rows(x, target_h - h4, "zero")
    local = target_h // axis.size
    slab = x[:, axis.index * local:(axis.index + 1) * local].contiguous()
    with torch.no_grad():
        out = transformer_forward_sharded(net, slab, axis=axis, precision=precision,
                                          dropout=False, extent=h4)
        full = gather_rows(out, axis)
    return full[:, :h, :w, :]
