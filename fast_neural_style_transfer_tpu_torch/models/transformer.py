"""Johnson-style feed-forward stylizer (TransformerNet) as an ``nn.Module``.

The module tree uses the reference ``StyleTransferNet`` names, so a
reference ``.pth`` loads with ``load_state_dict(strict=True)``:

    encoder:  conv1.conv  ReflectConv 3->64   k9 s2 | norm1 | ReLU
              conv2.conv  ReflectConv 64->256 k3 s2 | norm2 | ReLU
    body:     res_blocks.{0..4}: conv1.conv k3 | in1 | ReLU | Dropout2d(0.1)
                                 | conv2.conv k3 | in2 | + identity
    decoder:  up1.upsample_conv ConvTranspose 256->64 k3 s2 p1 op1 | norm3 | ReLU
              up2.upsample_conv ConvTranspose 64->32  k3 s2 p1 op1 | norm4 | ReLU
              final_conv.conv   ReflectConv 32->3 k9 s1, no activation

``layer_walk`` holds that sequence once; every forward of the stylizer
(this one, sharded, int8, ONNX, TorchScript) calls it with its own ops.

``forward`` takes and returns NHWC, like the JAX package's
``TransformerNet.apply``. In training mode (``net.train()``) each res block
drops whole channels per sample with rate 0.1 (``Dropout2d``), the masks
drawn from the ``generator`` passed to ``forward``; ``dropout=False`` turns
that off while keeping every other semantic, as the JAX step's
``dropout=False`` does for parity runs. Inside, ``permute(0, 3, 1, 2)`` of a contiguous
NHWC tensor is an NCHW tensor in ``torch.channels_last`` memory format at no
cost, and every activation stays channels_last: cuDNN runs NHWC and the
instance-norm kernel sees the physical NHWC layout. Parameters stay float32;
convs cast them to the compute dtype. Init is PyTorch's default.
``norm_method="onepass"`` normalizes with one-pass statistics (var =
max(E[x^2] - mean^2, 0)), as the JAX package's does; "auto" (the default)
with the stable ones.

Multi-style (conditional instance norm, the JAX package's ``num_styles``):
``TransformerNet(num_styles=S)`` keeps every IN affine as an (S, C) bank
under the same ``weight``/``bias`` keys, and ``forward(...,
style_weights=w)`` selects or blends rows: w is (S,) for the whole batch or
(B, S) per example, applied as ``w @ bank`` (training one-hots a style per
example). ``bake_style`` collapses a multi-style state_dict into a
single-style one.

Frozen IN statistics (video, ``infer/video.py``; the JAX package's
``return_stats`` / ``in_stats`` / ``stats_blend``): ``return_stats=True``
also returns the 14 sites' f32 (mean, var) pairs, each (N, C, 1, 1);
passing such a list back as ``in_stats`` (a pair may be (1, C, 1, 1), one
reference frame for the batch) normalizes with ``stats_blend * ref + (1 -
stats_blend) * own`` moments. Both run the IN forward kernel's capture and
inject modes (``ops/norm.py``), so capture then inject at blend 1 is the
plain forward bit for bit. This path is inference only.
"""

from __future__ import annotations

import operator
from functools import partial
from typing import Callable, Mapping, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from fast_neural_style_transfer_tpu_torch.core.dtypes import Precision
from fast_neural_style_transfer_tpu_torch.ops import (
    apply_instance_norm_stats,
    conv_transpose2d,
    instance_norm,
    instance_norm_stats,
    reflect_conv2d,
)

NUM_RES_BLOCKS = 5
DROPOUT_RATE = 0.1
NUM_IN_SITES = 4 + 2 * NUM_RES_BLOCKS


class ConvLayer(nn.Module):
    """A reflect conv's weights, in ``.conv``; ``layer_walk`` holds its stride."""

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k)


class UpsampleConv(nn.Module):
    """ConvTranspose2d k3 s2 p1 op1 (an exact 2x upsample)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.upsample_conv = nn.ConvTranspose2d(
            cin, cout, 3, stride=2, padding=1, output_padding=1)


class InstanceNorm(nn.Module):
    """Affine instance norm with the ``weight``/``bias`` keys of
    ``nn.InstanceNorm2d(affine=True)``: (C,), or an (S, C) bank for S
    styles; ReLU fuses into the same pass."""

    def __init__(self, c: int, num_styles: int = 1):
        super().__init__()
        shape = (c,) if num_styles == 1 else (num_styles, c)
        self.weight = nn.Parameter(torch.ones(shape))
        self.bias = nn.Parameter(torch.zeros(shape))

    def forward(self, x: torch.Tensor, relu: bool = False,
                style_weights: Optional[torch.Tensor] = None,
                onepass: bool = False,
                stats: Optional["_SiteStats"] = None) -> torch.Tensor:
        """``style_weights`` (a bank only): (S,) -> a (C,) affine, (N, S) ->
        an (N, C) affine, one row per sample. ``stats``: the forward's
        capture / inject state, which normalizes this site instead."""
        gamma, beta = self.weight, self.bias
        if style_weights is not None:
            gamma, beta = style_weights @ gamma, style_weights @ beta
        if stats is not None:
            return stats(x, gamma, beta, relu)
        return instance_norm(x, gamma, beta, relu=relu, onepass=onepass)


class _SiteStats:
    """One forward's frozen-statistics state, called at each IN site in
    order, as the JAX package's ``inorm``: takes the site's own (mean, var)
    where they are to be returned (``captured``, else None), and normalizes
    with them, or with ``ref[site]`` blended by ``blend`` where a reference
    is given, through ``ops/norm.py``'s ``instance_norm_stats`` (the kernel's
    capture mode) and ``apply_instance_norm_stats`` (its inject mode). A
    capture is so two launches a site: it runs once a clip."""

    def __init__(self, ref: Optional[Sequence], blend: float, capture: bool):
        self.ref = ref
        self.blend = float(blend)
        self.captured: Optional[list] = [] if capture else None
        self.site = 0

    def __call__(self, x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                 relu: bool) -> torch.Tensor:
        site, self.site = self.site, self.site + 1
        if self.captured is not None:
            self.captured.append(instance_norm_stats(x))
        if self.ref is None:
            (mean, var), blend = self.captured[-1], 1.0
        else:
            (mean, var), blend = self.ref[site], self.blend
        return apply_instance_norm_stats(x, mean.to(x.device), var.to(x.device),
                                         gamma, beta, relu=relu, blend=blend)


class ResidualBlock(nn.Module):
    def __init__(self, c: int = 256, num_styles: int = 1):
        super().__init__()
        self.conv1 = ConvLayer(c, c, 3)
        self.in1 = InstanceNorm(c, num_styles)
        self.conv2 = ConvLayer(c, c, 3)
        self.in2 = InstanceNorm(c, num_styles)


_BLOCKS = tuple(tuple(f"res_blocks.{i}.{m}" for m in ("conv1", "in1", "conv2", "in2"))
                for i in range(NUM_RES_BLOCKS))


def layer_walk(h, *, conv: Callable, up: Callable, inorm: Callable,
               add: Callable = operator.add, drop: Optional[Callable] = None):
    """The stylizer's layer sequence with its ops supplied, as ``tap_walk``
    is VGG19's: ``conv(name, h, stride)`` a reflect conv, ``up(name, h)`` the
    x2 ConvTranspose2d, ``inorm(name, h, relu)`` an IN site (a ReLU after
    all but each block's ``in2``), ``add(a, b)`` the residual, ``drop(h)``
    (optional) channel dropout after each block's ``in1``. Names are the
    layers' state_dict prefixes (``conv1``, ``norm1``, ``res_blocks.{i}.conv1``,
    ``res_blocks.{i}.in1``, ..., ``final_conv``), in registration order; ``h``
    is whatever the ops take (a tensor, replicas' tensors, an ONNX name)."""
    h = inorm("norm1", conv("conv1", h, 2), True)
    h = inorm("norm2", conv("conv2", h, 2), True)
    for conv1, in1, conv2, in2 in _BLOCKS:
        y = inorm(in1, conv(conv1, h, 1), True)
        if drop is not None:
            y = drop(y)
        h = add(h, inorm(in2, conv(conv2, y, 1), False))
    del y  # else the last block's activation lives on through the decoder
    h = inorm("norm3", up("up1", h), True)
    h = inorm("norm4", up("up2", h), True)
    return conv("final_conv", h, 1)


def channel_dropout(y: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """``Dropout2d``: the (N, C, 1, 1) mask drawn from ``generator`` (None:
    y's device's default)."""
    u = torch.rand((y.shape[0], y.shape[1], 1, 1), generator=generator, device=y.device)
    return torch.where(u < 1.0 - DROPOUT_RATE, y / (1.0 - DROPOUT_RATE),
                       torch.zeros((), dtype=y.dtype, device=y.device)).to(y.dtype)


class TransformerNet(nn.Module):
    """The stylizer, single-style or with (S, C) IN banks for
    ``num_styles`` S; registration order follows the reference (conv1,
    norm1, conv2, norm2, res_blocks, up1, norm3, up2, norm4, final_conv), so
    ``state_dict()`` keys come out in the reference's order and
    ``parameters()`` in the order torch Adam's state ids index.

    ``layers``: each ``layer_walk`` name -> the submodule holding its
    ``weight`` and ``bias``, resolved once so the forward parses no name (the
    submodules themselves: deepcopy, ``.to`` and load_state_dict keep it)."""

    def __init__(self, num_styles: int = 1):
        super().__init__()
        if num_styles < 1:
            raise ValueError(f"num_styles must be >= 1, got {num_styles}")
        self.num_styles = num_styles
        s = num_styles
        self.conv1 = ConvLayer(3, 64, 9)
        self.norm1 = InstanceNorm(64, s)
        self.conv2 = ConvLayer(64, 256, 3)
        self.norm2 = InstanceNorm(256, s)
        self.res_blocks = nn.ModuleList(
            ResidualBlock(256, s) for _ in range(NUM_RES_BLOCKS))
        self.up1 = UpsampleConv(256, 64)
        self.norm3 = InstanceNorm(64, s)
        self.up2 = UpsampleConv(64, 32)
        self.norm4 = InstanceNorm(32, s)
        self.final_conv = ConvLayer(32, 3, 9)
        self.layers = {
            name: m.conv if isinstance(m, ConvLayer)
            else m.upsample_conv if isinstance(m, UpsampleConv) else m
            for name, m in self.named_modules()
            if isinstance(m, (ConvLayer, UpsampleConv, InstanceNorm))}

    def forward(self, x: torch.Tensor,
                precision: Precision = Precision.f32(), *,
                generator: Optional[torch.Generator] = None,
                dropout: bool = True,
                style_weights=None,
                norm_method: str = "auto",
                in_stats: Optional[Sequence] = None,
                stats_blend: float = 1.0,
                return_stats: bool = False):
        """NHWC in, NHWC out (same dtype). H and W must be multiples of 4
        for an exact round trip. Dropout runs in training mode with
        ``dropout``, its masks drawn from ``generator`` (None: the default
        generator of x's device). ``style_weights``: (S,) or (B, S), needed
        by a multi-style net and refused by a single-style one.
        ``norm_method``: "auto" (stable) or "onepass" IN statistics.
        ``return_stats``: also return the list of the 14 sites' (mean, var),
        -> (out, stats). ``in_stats``: such a list, to normalize with
        ``stats_blend * ref + (1 - stats_blend) * own`` moments. Both take
        stable statistics and no gradient. Each site runs one inject
        launch, and one capture launch more where ``return_stats`` is set:
        a second pass over its input."""
        multi = self.num_styles > 1
        if multi and style_weights is None:
            raise ValueError(
                f"multi-style params ({self.num_styles} styles) need "
                "style_weights — or bake_style() them first")
        if not multi and style_weights is not None:
            raise ValueError("style_weights given but params are single-style")
        if norm_method not in ("auto", "onepass"):
            raise ValueError(f"unknown norm_method {norm_method!r}")
        if in_stats is not None and len(in_stats) != NUM_IN_SITES:
            raise ValueError(
                f"in_stats has {len(in_stats)} entries; this net has "
                f"{NUM_IN_SITES} IN sites (capture with return_stats=True)")
        stats = None
        if in_stats is not None or return_stats:
            if norm_method == "onepass":
                raise ValueError(
                    "norm_method='onepass' cannot be combined with in_stats/"
                    "return_stats: the stats path uses stable statistics")
            if not 0.0 <= stats_blend <= 1.0:
                raise ValueError(f"stats_blend must be in [0, 1], got {stats_blend}")
            if torch.is_grad_enabled() and any(p.requires_grad for p in self.parameters()):
                raise RuntimeError(
                    "in_stats/return_stats run inference only: call under "
                    "torch.no_grad() or torch.inference_mode()")
            stats = _SiteStats(in_stats, stats_blend, return_stats)
        if multi:
            style_weights = torch.as_tensor(style_weights, dtype=torch.float32,
                                            device=x.device)
        onepass = norm_method == "onepass"
        layers = self.layers

        def conv(name, v, stride):
            c = layers[name]
            return reflect_conv2d(v, c.weight, c.bias, stride=stride)

        def up(name, v):
            c = layers[name]
            return conv_transpose2d(v, c.weight, c.bias, stride=2, padding=1,
                                    output_padding=1)

        def inorm(name, v, relu):
            return layers[name](v, relu, style_weights, onepass, stats)

        # the NCHW input is the walk's alone, freed once conv1 has read it
        h = layer_walk(
            x.permute(0, 3, 1, 2).to(precision.compute_dtype).contiguous(
                memory_format=torch.channels_last),
            conv=conv, up=up, inorm=inorm, drop=partial(
                channel_dropout, generator=generator) if self.training and dropout else None)
        out = h.permute(0, 2, 3, 1).to(x.dtype)
        if return_stats:
            return out, stats.captured
        return out


def num_styles(state_dict: Mapping[str, torch.Tensor]) -> int:
    """1 for a single-style state_dict, S for one with (S, C) IN banks."""
    g = state_dict["norm1.weight"]
    return int(g.shape[0]) if g.dim() == 2 else 1


def bake_style(state_dict: Mapping[str, torch.Tensor],
               style_weights: Union[int, Sequence[float], np.ndarray, torch.Tensor]
               ) -> dict:
    """Collapse a multi-style state_dict into a single-style one: every
    (S, C) IN bank becomes ``w @ bank``, w the one-hot of an int style
    index or a length-S convex blend (weights >= 0 summing to 1 within
    1e-3). The result loads into ``TransformerNet()``."""
    s = num_styles(state_dict)
    if s == 1:
        raise ValueError("bake_style: params are already single-style")
    if isinstance(style_weights, bool):
        raise TypeError("style index must be an integer, not bool")
    if isinstance(style_weights, (int, np.integer)):
        idx = int(style_weights)
        if not 0 <= idx < s:
            raise ValueError(f"style index {idx} out of range [0, {s})")
        w = torch.zeros(s)
        w[idx] = 1.0
    else:
        w = torch.as_tensor(np.asarray(style_weights, np.float32))
        if tuple(w.shape) != (s,):
            raise ValueError(f"style_weights shape {tuple(w.shape)} != ({s},) "
                             f"for a {s}-style net")
        if (w < 0).any() or abs(float(w.sum()) - 1.0) > 1e-3:
            raise ValueError(
                f"style blend weights must be convex (>= 0, sum to 1); got "
                f"{w.tolist()} with sum {float(w.sum()):.4f}")
    # only the IN banks are 2-D; conv weights are 4-D, biases 1-D
    return {k: (w.to(v.device) @ v.float() if v.dim() == 2 else v)
            for k, v in state_dict.items()}


def require_single_style(state_dict: Mapping[str, torch.Tensor], what: str) -> None:
    """Raise, with the fix, where a path takes single-style params only."""
    s = num_styles(state_dict)
    if s > 1:
        raise ValueError(
            f"{what} needs single-style params, but this net has {s} "
            "conditional-IN styles — bake_style(params, <index or blend>) "
            "first (the CLIs' --style_index/--style_blend do this)")
