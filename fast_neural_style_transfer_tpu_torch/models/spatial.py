"""Height-sharded model forwards (the JAX package's ``models/spatial.py``).

The stylizer's ``layer_walk`` and VGG19's ``tap_walk`` with the layer ops of
``ops/sharded.py``: a halo exchange per layer makes the convs exact
and instance norm takes its statistics over the whole image, so outputs
equal the unsharded forwards' to rounding (``tests/test_torch_spatial*.py``
hold them against the JAX package's).

Local H per rank: divisible by 4 for the stylizer (two stride-2 encoder
convs), by 8 for VGG through relu4_3 (three 2x2 pools).

Dropout masks are per (sample, channel): every rank draws the same mask
from a generator seeded alike on every rank, which is channel dropout on
the unsharded image.
"""

from __future__ import annotations

from functools import partial
from typing import List, Optional, Sequence

import torch
from torch import nn

from fast_neural_style_transfer_tpu_torch.core.dtypes import Precision
from fast_neural_style_transfer_tpu_torch.models.transformer import (
    channel_dropout,
    layer_walk,
)
from fast_neural_style_transfer_tpu_torch.models.vgg import tap_walk
from fast_neural_style_transfer_tpu_torch.ops import sharded as sh


def transformer_forward_sharded(
    net: nn.Module,
    x: torch.Tensor,
    *,
    axis,
    precision: Precision = Precision.f32(),
    generator: Optional[torch.Generator] = None,
    dropout: bool = True,
    extent: Optional[int] = None,
) -> torch.Tensor:
    """A single-style ``TransformerNet``'s forward on this rank's NHWC slab
    ``x``: its ``layer_walk`` with halo-exchanging ops; NHWC out, x's dtype.
    Dropout runs in training mode with ``dropout``, its masks from
    ``generator``.

    ``extent`` (global active H at input scale, a multiple of 4): rows below
    it compute as the unsharded forward on an extent-tall input. Reflect
    convs pin the boundary rows an unsharded reflect pad would supply,
    instance norms leave the dead rows out of their moments, transpose
    convs zero the one boundary row their padding expects, and the extent
    follows the stride-2 downs and x2 ups. A k9 stride-1 conv's active
    outputs read all 4 pad rows, a k9 stride-2 conv's 3, a k3 stride-2
    conv's none. None (training, aligned serving) is the plain path."""
    if getattr(net, "num_styles", 1) > 1:
        raise ValueError("the sharded forward is single-style (bake_style first)")
    dt = precision.compute_dtype
    layers = net.layers
    e = extent  # global active H at the current scale

    # conv and up pin at the input scale, then move e to the output scale,
    # which the instance norm after them masks with
    def conv(name, v, stride):
        nonlocal e
        c = layers[name]
        if e is not None:
            pad = c.weight.shape[-1] // 2
            pin = pad if stride == 1 else pad - stride + 1
            if pin > 0:
                v = sh.pin_reflect_rows(v, e, pin, axis)
            e //= stride
        return sh.reflect_conv2d_sharded(v, c.weight, c.bias, stride=stride,
                                         axis=axis).to(dt)

    def up(name, v):
        nonlocal e
        c = layers[name]
        if e is not None:
            # transpose-conv padding is zeros: the one input row past the
            # extent that active outputs read must be zero, not slab padding
            v = sh.set_global_row(v, e, torch.zeros_like(v[:, :, :1]), axis)
            e *= 2
        return sh.conv_transpose2d_sharded(v, c.weight, c.bias, axis=axis).to(dt)

    def inorm(name, v, relu):
        n = layers[name]
        return sh.instance_norm_sharded(v, n.weight, n.bias, relu=relu,
                                        axis=axis, extent=e)

    h = layer_walk(  # the NCHW input is the walk's alone, freed once conv1 has read it
        x.permute(0, 3, 1, 2).to(dt).contiguous(memory_format=torch.channels_last),
        conv=conv, up=up, inorm=inorm, drop=partial(
            channel_dropout, generator=generator) if net.training and dropout else None)
    return h.permute(0, 2, 3, 1).to(x.dtype)


def vgg_features_sharded(
    vgg: nn.Module,
    x: torch.Tensor,
    taps: Sequence[str],
    *,
    axis,
    precision: Precision = Precision.f32(),
    extent: Optional[int] = None,
) -> List[torch.Tensor]:
    """The sharded mirror of ``VGG19Features.forward``: ``tap_walk`` with
    halo-exchanging convs and local pools; NHWC slab in, NHWC taps out.

    ``extent`` (global active H at input scale, a multiple of 8): rows at or
    past it are zeroed after every conv, which makes rows below it equal to
    an unsharded forward on an input of exactly ``extent`` rows (zero-SAME
    convs see zeros past the true boundary either way), provided the
    caller zero-fills the input past it. Pools halve the extent."""
    if extent is None:
        def conv_fn(name, conv, h):
            return sh.conv2d_same_sharded(h, conv.weight, conv.bias, axis=axis)

        pool_fn = sh.max_pool2d_sharded
    else:
        state = {"e": extent}

        def conv_fn(name, conv, h):
            out = sh.conv2d_same_sharded(h, conv.weight, conv.bias, axis=axis)
            # re-zero the dead rows: the bias (then the ReLU) would revive
            # them and leak into the next layer's boundary rows
            return sh.mask_rows_from(out, state["e"], axis)

        def pool_fn(h):
            state["e"] //= 2
            return sh.max_pool2d_sharded(h)

    return tap_walk(vgg, x, taps, conv_fn=conv_fn, pool_fn=pool_fn, precision=precision)
