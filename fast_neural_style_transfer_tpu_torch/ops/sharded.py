"""Height-sharded building blocks (the JAX package's ``ops/sharded.py``).

Everything a stylizer forward, a VGG-19 forward and the perceptual losses
need when an image's rows are split over ranks (``parallel/mesh.py``):

- reflect / zero-padded convs with a halo exchange per layer, reflecting or
  zero-padding at the true image edges, so that the results equal the
  unsharded ops';
- the decoder's k3/s2/p1/op1 transpose conv (one halo row from the next
  rank, zeros at the global bottom);
- instance norm with global statistics: both IN kernels split around a
  cross-rank exchange (``ops/cuda_norm.py::ShardedInstanceNormFn``);
- Gram matrix, content and TV losses with their cross-rank sums (TV adds
  the seam between adjacent ranks); with ``batch_axes`` (the 2-D data x
  space mesh) the loss sums span the data ranks too, and TV divides by
  the global batch.

Tensors are (N, C, H, W), H this rank's slab, in ``torch.channels_last``
memory format as everywhere in the port; ``axis`` is the ``SpaceAxis``.
Every function is differentiable: an exchange sends its gradient back to
the rank that sent the rows, and a loss's cross-rank sum has an identity
backward (``SpaceAxis.psum``), so each rank's parameter gradients are its
share, summed once by the train step. The convs are cuDNN's, as JAX's
``_conv_valid`` is plain ``lax``: no Pallas kernel is behind them.

``extent`` (a Python int): the global active height; rows at or past it
are slab padding (an unaligned image), kept out of the statistics and the
reflections (``mask_rows_from``, ``pin_reflect_rows``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from fast_neural_style_transfer_tpu_torch.ops.cuda_norm import (
    ShardedInstanceNormFn,
    sharded_instance_norm_fwd,
)


def from_prev(rows: torch.Tensor, axis) -> torch.Tensor:
    """Each rank receives ``rows`` from its previous (upper) neighbour."""
    return axis.from_prev(rows)


def from_next(rows: torch.Tensor, axis) -> torch.Tensor:
    """Each rank receives ``rows`` from its next (lower) neighbour."""
    return axis.from_next(rows)


def _is(cond: bool, device) -> torch.Tensor:
    """``cond`` as a 0-dim bool tensor: ``torch.where`` on it keeps both
    branches in the graph, so every rank runs every exchange's backward."""
    return torch.tensor(cond, device=device)


def halo_extend(x: torch.Tensor, p: int, *, mode: str, axis) -> torch.Tensor:
    """Extend the local slab by p rows on each side: the neighbours' rows
    inside the image; at the true image edges, reflection (``mode=
    'reflect'``, torch ReflectionPad) or zeros (``mode='zero'``, Conv2d's
    padding)."""
    if p == 0:
        return x
    h = x.shape[2]
    need = p + 1 if mode == "reflect" else p
    if h < need:
        raise ValueError(
            f"local H slab of {h} rows is too small for a halo of p={p} "
            f"({mode} mode needs >= {need} rows per shard); use fewer "
            "'space' shards or a taller image")
    top_halo = from_prev(x[:, :, -p:], axis)
    bot_halo = from_next(x[:, :, :p], axis)
    if mode == "reflect":
        top_edge = x[:, :, 1:p + 1].flip(2)
        bot_edge = x[:, :, -p - 1:-1].flip(2)
    elif mode == "zero":
        top_edge = torch.zeros_like(top_halo)
        bot_edge = torch.zeros_like(bot_halo)
    else:
        raise ValueError(f"unknown halo mode {mode!r}")
    top = torch.where(_is(axis.index == 0, x.device), top_edge, top_halo)
    bot = torch.where(_is(axis.index == axis.size - 1, x.device), bot_edge, bot_halo)
    return torch.cat([top, x, bot], dim=2).contiguous(memory_format=torch.channels_last)


def global_row_index(local_h: int, axis, device=None) -> torch.Tensor:
    """(local_h,) int64: each local row's global H index."""
    return axis.index * local_h + torch.arange(local_h, device=device)


def local_rows(local_h: int, extent: Optional[int], axis) -> int:
    """How many of this rank's rows lie above the global ``extent`` (all of
    them for None): clamp(extent - index * local_h, 0, local_h)."""
    if extent is None:
        return local_h
    return max(0, min(local_h, extent - axis.index * local_h))


def mask_rows_from(x: torch.Tensor, extent: int, axis) -> torch.Tensor:
    """Zero every row whose global index is >= ``extent`` (no exchange)."""
    keep = global_row_index(x.shape[2], axis, x.device) < extent
    return torch.where(keep[None, None, :, None], x, torch.zeros((), dtype=x.dtype,
                                                                 device=x.device))


def fetch_global_row(x: torch.Tensor, i: int, axis) -> torch.Tensor:
    """Global row ``i`` of the sharded map as a (B, C, 1, W) tensor on every
    rank: a one-hot masked sum, then a sum over the ranks (whose backward
    sums the ranks' gradients: the row is used on one rank only)."""
    sel = global_row_index(x.shape[2], axis, x.device) == i
    row = torch.where(sel[None, None, :, None], x,
                      torch.zeros((), dtype=x.dtype, device=x.device)).sum(2, keepdim=True)
    return axis.psum_varying(row)


def set_global_row(x: torch.Tensor, i: int, value: torch.Tensor, axis) -> torch.Tensor:
    """Write the (B, C, 1, W) ``value`` into global row ``i``; rows outside
    this rank's slab (or the image) leave x as it is. No exchange."""
    li = i - axis.index * x.shape[2]
    if not 0 <= li < x.shape[2]:
        return x
    x = x.clone()
    x[:, :, li:li + 1] = value.to(x.dtype)
    return x


def pin_reflect_rows(x: torch.Tensor, extent: int, pad: int, axis) -> torch.Tensor:
    """Make rows [extent, extent + pad) hold what an unsharded reflect pad
    supplies at an array ending at ``extent``: row extent + i := row extent
    - 2 - i. Then a reflect conv's output rows below the extent match the
    unsharded conv on the extent-tall input. Pins at or past the global H
    are skipped (the aligned case: ``halo_extend``'s true edge reflects).
    A pin within one rank's slab is a local copy; across ranks, one one-row
    sum over the ranks."""
    h = x.shape[2]
    h_global = h * axis.size
    for i in range(pad):
        dst, src = extent + i, extent - 2 - i
        if dst >= h_global:
            continue
        if dst // h == src // h:
            if dst // h == axis.index:
                row = x[:, :, src - axis.index * h:src - axis.index * h + 1]
                x = set_global_row(x, dst, row, axis)
        else:
            x = set_global_row(x, dst, fetch_global_row(x, src, axis), axis)
    return x


def reflect_conv2d_sharded(x, w, b, *, stride: int = 1, axis) -> torch.Tensor:
    """ReflectConv (weight OIHW) with H halo-exchanged and W reflect-padded
    locally; weight and bias cast to x's dtype."""
    k = w.shape[-1]
    pad = k // 2
    if stride > 1 and x.shape[2] % stride:
        # stride-s windows must start at globally aligned offsets on every
        # rank; an odd local H would compute windows the unsharded conv
        # never evaluates
        raise ValueError(f"local H {x.shape[2]} not divisible by stride {stride}; "
                         "sharded strided convs need stride-aligned slabs")
    x = halo_extend(x, pad, mode="reflect", axis=axis)
    if pad:
        # the CUDA reflect pad writes NCHW: back to channels_last, or cuDNN
        # runs the conv in NCHW with layout conversions around it
        x = F.pad(x, (pad, pad, 0, 0), mode="reflect").contiguous(
            memory_format=torch.channels_last)
    return F.conv2d(x, w.to(x.dtype), None if b is None else b.to(x.dtype),
                    stride=stride)


def conv2d_same_sharded(x, w, b, *, axis) -> torch.Tensor:
    """Zero-padded SAME conv (VGG's, stride 1) with an H halo exchange."""
    pad = w.shape[-1] // 2
    x = halo_extend(x, pad, mode="zero", axis=axis)
    return F.conv2d(x, w.to(x.dtype), None if b is None else b.to(x.dtype),
                    padding=(0, pad))


def max_pool2d_sharded(x: torch.Tensor) -> torch.Tensor:
    """2x2 / 2 max pool. Windows never cross ranks when the local H is
    even (checked), so no halo is needed."""
    if x.shape[2] % 2:
        raise ValueError(f"local H {x.shape[2]} not divisible by pool stride 2")
    return F.max_pool2d(x, kernel_size=2, stride=2)


def conv_transpose2d_sharded(x, w, b, *, axis) -> torch.Tensor:
    """k3/s2/p1/op1 transpose conv (weight IOHW): one halo row from the next
    rank (zeros on the last: transpose-conv padding is zeros). Output row o
    of the local 2h reads input rows (o + 1 - k) / 2, the halo row for the
    last."""
    halo = from_next(x[:, :, :1], axis)
    bot = torch.where(_is(axis.index == axis.size - 1, x.device),
                      torch.zeros_like(halo), halo)
    ext = torch.cat([x, bot], dim=2).contiguous(memory_format=torch.channels_last)
    out = F.conv_transpose2d(ext, w.to(x.dtype), None if b is None else b.to(x.dtype),
                             stride=2, padding=1, output_padding=1)
    return out[:, :, :2 * x.shape[2]]


def instance_norm_sharded(x, gamma, beta, *, axis, eps: float = 1e-5,
                          relu: bool = False, extent: Optional[int] = None):
    """IN + affine (+ReLU) with statistics over the whole image: the IN
    kernels' statistics and apply passes with the ranks' moments merged
    between them (``ShardedInstanceNormFn``). ``extent``: rows at or past it
    are left out of the moments (and come out as relu(beta), the JAX
    formula's value there); inference only."""
    x = x.contiguous(memory_format=torch.channels_last)
    rows = local_rows(x.shape[2], extent, axis)
    if torch.is_grad_enabled() and (
            x.requires_grad or gamma.requires_grad or beta.requires_grad):
        masked = extent is not None and extent < x.shape[2] * axis.size
        return ShardedInstanceNormFn.apply(x, gamma, beta, axis, rows, masked, eps, relu)
    return sharded_instance_norm_fwd(x, gamma, beta, axis, rows=rows, eps=eps,
                                     relu=relu)[0]


def gram_matrix_sharded(feat: torch.Tensor, axis) -> torch.Tensor:
    """Global (b, c, c) float32 Gram of a sharded NHWC feature map: the local
    Gram, summed over the ranks (the spatial sum splits over them)."""
    b, h, w, c = feat.shape
    f = feat.float().reshape(b, h * w, c)
    return axis.psum(torch.bmm(f.transpose(1, 2), f))


def psum_over(t: torch.Tensor, axes) -> torch.Tensor:
    """``t`` summed over each axis of ``axes`` in turn (``psum``: identity
    backward)."""
    for a in axes:
        t = a.psum(t)
    return t


def content_loss_sharded(input_feat, target_feat, axis, batch_axes=()) -> torch.Tensor:
    """The content loss, sum-MSE / (c * h_global * w), over sharded NHWC
    maps. ``batch_axes``: the axes the batch is split over too (the 2-D
    data x space step): the sum spans them as well, as the loss sums over
    the batch."""
    diff = input_feat.float() - target_feat.float()
    b, h, w, c = input_feat.shape
    total = psum_over(torch.sum(diff.square()), (axis, *batch_axes))
    return total / (c * h * axis.size * w)


def total_variation_loss_sharded(img: torch.Tensor, axis, batch_axes=()) -> torch.Tensor:
    """Anisotropic TV over a sharded NHWC image, with the seam between the
    last row of rank i and the first of rank i + 1; over b_global * c *
    h_global * w, b_global the batch over ``batch_axes`` too."""
    x = img.float()
    b, h, w, c = x.shape
    tv_h = torch.sum((x[:, 1:] - x[:, :-1]).square())
    tv_w = torch.sum((x[:, :, 1:] - x[:, :, :-1]).square())
    prev_last = axis.from_prev(x[:, -1:].contiguous())
    seam = torch.sum((x[:, :1] - prev_last).square())
    seam = torch.where(_is(axis.index == 0, x.device), torch.zeros_like(seam), seam)
    b_global = b
    for a in batch_axes:
        b_global *= a.size
    total = psum_over(tv_h + tv_w + seam, (axis, *batch_axes))
    return total / (b_global * c * h * axis.size * w)
