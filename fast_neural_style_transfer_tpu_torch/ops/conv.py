"""Convolutions and pooling of the stylizer and of VGG, in the direct form.

Tensors are (N, C, H, W) in ``torch.channels_last`` memory format, weights
in PyTorch's layouts (Conv2d OIHW, ConvTranspose2d IOHW). XLA lowered these
ops for the JAX package, so here they go to cuDNN (or the CPU's convs):

- ``reflect_pad_hw``: ReflectionPad2d, with an optional ReLU and nearest x2
  upsample before it, staged by the hand-written kernel of
  ``ops/cuda_pad.py`` where no gradient is needed;
- ``reflect_conv2d``: ReflectionPad2d(k // 2) + valid Conv2d; the
  stylizer's 32 -> 3 9x9 ``final_conv`` in a bf16 forward on a card that
  needs no gradient runs the hand-written kernel of ``ops/cuda_conv_rgb.py``
  (``takes_rgb`` decides from the call's operands), every other conv cuDNN;
- ``conv_transpose2d``: ConvTranspose2d(stride, padding, output_padding);
- ``conv2d_same``: zero-padded Conv2d(padding=k // 2), VGG's convs. With
  ``small_cin_kernel`` its backward is the hand-written kernel of
  ``ops/cuda_conv.py`` (VGG conv1_1); otherwise cuDNN's;
- ``max_pool2d``: 2x2 / 2 VALID max pool with PyTorch's gradient, which
  routes a window's gradient to its first maximum. XLA's select-and-scatter
  may pick another of tied maxima; on VGG's pools ties sit at post-ReLU
  zeros, whose gradient the ReLU below zeroes either way.

The JAX package's s2d, same_delta and subpixel lowerings are XLA
reformulations of the same math and have no counterpart here.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from fast_neural_style_transfer_tpu_torch.ops import _build
from fast_neural_style_transfer_tpu_torch.ops.cuda_conv import Conv2dSameSmallCinFn
from fast_neural_style_transfer_tpu_torch.ops.cuda_conv_rgb import conv_to_rgb, takes_rgb
from fast_neural_style_transfer_tpu_torch.ops.cuda_pad import reflect_pad, reflect_pad_reference


def reflect_pad_hw(x: torch.Tensor, pad: int, *, relu: bool = False,
                   upsample: int = 1) -> torch.Tensor:
    """Reflect-pad H and W by ``pad`` on each side, keeping channels_last:
    ``pad_reflect(up(relu(x)))``, with ``relu`` a ReLU first and
    ``upsample`` 2 a nearest x2 upsample after it.

    A tensor that needs a gradient takes ``torch.relu``, ``F.interpolate``
    and ``F.pad`` under autograd; otherwise a CUDA tensor launches the
    kernel (``ops/cuda_pad.py``; it raises on what the kernel does not
    take) and a CPU tensor takes its plain version. All three give the same
    bits. ``reflect_pad_hw.launches`` counts the kernel's launches."""
    if pad == 0 and not relu and upsample == 1:
        return x
    if x.requires_grad and torch.is_grad_enabled():
        if relu:
            x = torch.relu(x)
        if upsample != 1:
            x = F.interpolate(x, scale_factor=upsample, mode="nearest")
            x = x.contiguous(memory_format=torch.channels_last)
        x = F.pad(x, (pad, pad, pad, pad), mode="reflect")
        return x.contiguous(memory_format=torch.channels_last)
    if x.is_cpu:
        return reflect_pad_reference(x, pad, relu=relu, upsample=upsample)
    y = reflect_pad(x, pad, relu=relu, upsample=upsample)
    reflect_pad_hw.launches += 1
    return y


# calls that launched the reflect-pad kernel
_build.counted(reflect_pad_hw)


def reflect_conv2d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor],
    *,
    stride: int = 1,
    relu: bool = False,
    upsample: int = 1,
) -> torch.Tensor:
    """Reflection-padded conv: pad = k // 2 on both sides, then a VALID conv,
    of ``up(relu(x))`` (``reflect_pad_hw``'s ``relu`` and ``upsample``).
    Weight and bias are cast to x's dtype. Where ``takes_rgb`` holds, the
    conv is the kernel's (``conv_to_rgb.launches`` counts it), else cuDNN's."""
    k = weight.shape[-1]
    rgb = takes_rgb(x, weight, bias, stride=stride, relu=relu, upsample=upsample)
    x = reflect_pad_hw(x, k // 2, relu=relu, upsample=upsample)
    weight = weight.to(x.dtype)
    bias = None if bias is None else bias.to(x.dtype)
    if rgb:
        return conv_to_rgb(x, weight, bias)
    return F.conv2d(x, weight, bias, stride=stride)


def conv_transpose2d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor],
    *,
    stride: int,
    padding: int,
    output_padding: int,
) -> torch.Tensor:
    """PyTorch ConvTranspose2d: out = (in - 1) * s - 2p + k + op. Weight and
    bias are cast to x's dtype."""
    bias = None if bias is None else bias.to(x.dtype)
    return F.conv_transpose2d(x, weight.to(x.dtype), bias, stride=stride,
                              padding=padding, output_padding=output_padding)


def conv2d_same(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor],
    *,
    small_cin_kernel: bool = False,
) -> torch.Tensor:
    """Stride-1 conv with PyTorch ``padding=k//2`` (JAX ``conv2d_same``).
    Weight and bias are cast to x's dtype. ``small_cin_kernel``: when x
    needs a gradient, take it from the hand-written backward kernel
    (odd k, k*k*C_in <= 128; on a CUDA tensor outside that gate it raises)."""
    w = weight.to(x.dtype)
    b = None if bias is None else bias.to(x.dtype)
    if small_cin_kernel and torch.is_grad_enabled() and x.requires_grad:
        return Conv2dSameSmallCinFn.apply(x, w, b)
    return F.conv2d(x, w, b, padding=weight.shape[-1] // 2)


def max_pool2d(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 VALID max pool (VGG's pools), keeping channels_last."""
    return F.max_pool2d(x, kernel_size=2, stride=2)
