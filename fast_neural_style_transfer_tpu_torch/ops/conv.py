"""Convolutions and pooling of the stylizer and of VGG, in the direct form.

Tensors are (N, C, H, W) in ``torch.channels_last`` memory format, weights
in PyTorch's layouts (Conv2d OIHW, ConvTranspose2d IOHW). XLA lowered these
ops for the JAX package, so here they go to cuDNN (or the CPU's convs):

- ``reflect_conv2d``: ReflectionPad2d(k // 2) + valid Conv2d;
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

from fast_neural_style_transfer_tpu_torch.ops.cuda_conv import Conv2dSameSmallCinFn


def reflect_pad_hw(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect-pad H and W by ``pad`` on each side, keeping channels_last."""
    if pad == 0:
        return x
    x = F.pad(x, (pad, pad, pad, pad), mode="reflect")
    return x.contiguous(memory_format=torch.channels_last)


def reflect_conv2d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor],
    *,
    stride: int = 1,
) -> torch.Tensor:
    """Reflection-padded conv: pad = k // 2 on both sides, then a VALID conv.
    Weight and bias are cast to x's dtype."""
    k = weight.shape[-1]
    x = reflect_pad_hw(x, k // 2)
    bias = None if bias is None else bias.to(x.dtype)
    return F.conv2d(x, weight.to(x.dtype), bias, stride=stride)


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
