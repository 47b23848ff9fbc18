"""Height-sharded AdaIN inference (the JAX package's
``infer/spatial_adain.py``): arbitrary-style transfer of a large image over
several ranks.

The content image's rows are split over the ranks: the VGG encode and the
decoder's convs exchange halos, and the AdaIN transform at relu4_1 is the
sharded instance norm with the style's moments as its per-sample affine
(gamma = sigma_s, beta = mu_s): the IN kernels' statistics pass, the
ranks' moments merged, the apply pass. Overlap tiling would be wrong here,
as it is for instance norm: the re-normalization couples every pixel to
the global moments.

The style images only give channel statistics, so they are encoded
unsharded (styles are small) on every rank. Style interpolation folds into
one (mu, sigma) pair: sum_s w_s (sigma_s c_norm + mu_s) = (sum_s w_s
sigma_s) c_norm + sum_s w_s mu_s. Per-pixel style masks (paper section 7.3)
fold the same way per pixel, with no exchange.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fast_neural_style_transfer_tpu_torch.core.dtypes import Precision
from fast_neural_style_transfer_tpu_torch.core.shapes import pad_to_multiple_reflect
from fast_neural_style_transfer_tpu_torch.infer.spatial import gather_rows, pad_rows, slab_heights
from fast_neural_style_transfer_tpu_torch.models.adain import (
    _DECODER_CFG,
    ENCODE_TAP,
    blended_style_stats,
    channel_stats,
    feature_masks,
    resolve_style_weights,
)
from fast_neural_style_transfer_tpu_torch.models.spatial import vgg_features_sharded
from fast_neural_style_transfer_tpu_torch.ops import sharded as sh
from fast_neural_style_transfer_tpu_torch.ops.cuda_norm import (
    instance_norm_moments,
    merge_moments,
)


def channel_stats_sharded(x: torch.Tensor, *, axis, eps: float = 1e-5,
                          extent: Optional[int] = None):
    """Global per-(b, c) mean and std of a sharded NHWC map, each (B, 1, 1,
    C) f32 (biased variance): the sharded mirror of
    ``models.adain.channel_stats``. The sharded IN's statistics pass (the
    kernel's statistics-only route on a CUDA tensor) over this rank's rows
    below ``extent``, the ranks' moments merged. No autograd."""
    xc = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    rows = sh.local_rows(xc.shape[2], extent, axis)
    mean, var = instance_norm_moments(xc, rows)
    count = torch.full_like(mean, float(rows * xc.shape[3]))
    gmean, gvar = merge_moments(axis.gather(torch.stack([count, mean, var]).double()))
    return gmean[:, None, None, :], torch.sqrt(gvar + eps)[:, None, None, :]


def adain_decoder_forward_sharded(decoder: nn.Module, feat: torch.Tensor, *, axis,
                                  precision: Precision = Precision.f32(),
                                  extent: Optional[int] = None) -> torch.Tensor:
    """The sharded mirror of ``AdaINDecoder.forward`` on this rank's NHWC
    slab: reflect convs exchange their one-row halos; nearest x2 upsampling
    is local (each output row reads one input row).

    ``extent`` (global active H of ``feat``): each conv first writes row
    extent - 2 into row ``extent``, the one row the unsharded reflect pad
    supplies at an array ending there, so rows below the extent match the
    decoder on the extent-tall input. Rows past it influence nothing below
    it and are cropped by the caller. Upsampling doubles the extent."""
    dt = precision.compute_dtype
    x = feat.permute(0, 3, 1, 2).to(dt).contiguous(memory_format=torch.channels_last)
    last = len(_DECODER_CFG) - 1
    for i, ((_, up), conv) in enumerate(zip(_DECODER_CFG, decoder.convs())):
        if up:
            x = F.interpolate(x, scale_factor=2, mode="nearest")
            x = x.contiguous(memory_format=torch.channels_last)
            if extent is not None:
                extent *= 2
        if extent is not None:
            x = sh.pin_reflect_rows(x, extent, 1, axis)
        x = sh.reflect_conv2d_sharded(x, conv.weight, conv.bias, axis=axis)
        if i != last:
            x = torch.relu(x)
        x = x.to(dt)
    return x.permute(0, 2, 3, 1)


def _adain_target(c_feat, mu_s, sigma_s, masks_f, alpha, *, axis, e_f):
    """The AdaIN target on this rank's relu4_1 slab (NHWC), blended with
    the content feature by ``alpha``, in f32. Unmasked: the sharded IN with
    gamma = sigma_s, beta = mu_s ((B or 1, 1, 1, C)). Masked: (S, 1, 1, C)
    stacks folded per pixel by ``masks_f`` (S, h, W)."""
    cf = c_feat.float()
    c = c_feat.shape[-1]
    if masks_f is None:
        gamma, beta = sigma_s.reshape(-1, c), mu_s.reshape(-1, c)
        if gamma.shape[0] == 1:
            gamma, beta = gamma[0], beta[0]
        xc = c_feat.permute(0, 3, 1, 2)
        t = sh.instance_norm_sharded(xc, gamma, beta, axis=axis, extent=e_f)
        t = t.permute(0, 2, 3, 1).float()
    else:
        mu_c, sigma_c = channel_stats_sharded(c_feat, axis=axis, extent=e_f)
        c_norm = (cf - mu_c) / sigma_c
        s = mu_s.shape[0]
        sig_eff = torch.einsum("shw,sc->hwc", masks_f, sigma_s.reshape(s, -1))[None]
        mu_eff = torch.einsum("shw,sc->hwc", masks_f, mu_s.reshape(s, -1))[None]
        t = sig_eff * c_norm + mu_eff
    return alpha * t + (1.0 - alpha) * cf


def stylize_arbitrary_spatial(
    decoder: nn.Module,
    vgg: nn.Module,
    content: torch.Tensor,
    style,
    plan,
    *,
    alpha: float = 1.0,
    style_weights=None,
    style_masks=None,
    precision: Precision = Precision.f32(),
) -> torch.Tensor:
    """``models.adain.stylize_arbitrary`` with the content's rows split over
    ``plan``'s ranks; ``content`` network-space NHWC, the same on every rank,
    on the rank's device -> the NHWC output, content's shape, on every rank.

    It matches the single-device route (reflect-pad to a multiple of 8, run,
    crop) to f32 rounding at any size. Stage 1 is that exact pad (edge
    padding up to 16 rows for tiny images); stage 2 zero-fills to the
    equal-slab height (a multiple of 8 * ranks, >= 16 rows a rank), and the
    forward keeps those rows out of every conv, the AdaIN moments and the
    decoder's reflections. ``style``: one NHWC image or a list (interpolated
    by ``style_weights``). ``style_masks`` (S, H, W): per-pixel style
    weights, exclusive with ``style_weights``; pooled to the feature grid as
    on one device, then split with the content."""
    axis = plan.space
    if style_masks is not None and style_weights is not None:
        raise ValueError("style_masks and style_weights are mutually exclusive: "
                         "masks are per-pixel weights already")
    with torch.no_grad():
        if style_masks is None:
            mu_s, sigma_s = blended_style_stats(vgg, style, style_weights,
                                                precision=precision)
        else:
            styles, _ = resolve_style_weights(style, None)
            stats = [channel_stats(vgg(s, (ENCODE_TAP,), precision=precision)[0])
                     for s in styles]
            mu_s = torch.cat([m for m, _ in stats])
            sigma_s = torch.cat([sd for _, sd in stats])

        n, h, w, _ = content.shape
        x, _ = pad_to_multiple_reflect(content, 8)
        x = pad_rows(x, 16 - x.shape[1], "edge")
        h8, target_h = slab_heights(x.shape[1], 8, 16, axis.size)
        x = pad_rows(x, target_h - h8, "zero")
        local = target_h // axis.size
        slab = x[:, axis.index * local:(axis.index + 1) * local].contiguous()
        masks_f = None
        if style_masks is not None:
            m = torch.as_tensor(np.asarray(style_masks, np.float32))
            if m.dim() != 3 or tuple(m.shape[1:]) != (h, w):
                raise ValueError(f"style_masks must be (S, {h}, {w}); got {tuple(m.shape)}")
            m = F.pad(m[None], (0, x.shape[2] - w, 0, h8 - h), mode="replicate")[0]
            masks_f = feature_masks(m.numpy(), (h8, x.shape[2]), m.shape[0])
            masks_f = F.pad(masks_f, (0, 0, 0, (target_h - h8) // 8))
            lf = local // 8
            masks_f = masks_f[:, axis.index * lf:(axis.index + 1) * lf].to(x.device)

        (c_feat,) = vgg_features_sharded(vgg, slab, (ENCODE_TAP,), axis=axis,
                                         precision=precision, extent=h8)
        e_f = h8 // 8  # three pools down to the relu4_1 scale
        t = _adain_target(c_feat, mu_s, sigma_s, masks_f, alpha, axis=axis, e_f=e_f)
        out = adain_decoder_forward_sharded(decoder, t.to(c_feat.dtype), axis=axis,
                                            precision=precision, extent=e_f)
        full = gather_rows(out, axis)
    return full[:, :h, :w, :]
