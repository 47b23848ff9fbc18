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

Multi-style (S, C) banks, IN statistics capture/inject and the choice of
statistics method are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from fast_neural_style_transfer_tpu_torch.core.dtypes import Precision
from fast_neural_style_transfer_tpu_torch.ops import (
    conv_transpose2d,
    instance_norm,
    reflect_conv2d,
)

NUM_RES_BLOCKS = 5
DROPOUT_RATE = 0.1
NUM_IN_SITES = 4 + 2 * NUM_RES_BLOCKS


class ConvLayer(nn.Module):
    """Reflection pad (k // 2) + Conv2d; the weights live in ``.conv``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride=stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return reflect_conv2d(x, self.conv.weight, self.conv.bias,
                              stride=self.conv.stride[0])


class UpsampleConv(nn.Module):
    """ConvTranspose2d k3 s2 p1 op1 (an exact 2x upsample)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.upsample_conv = nn.ConvTranspose2d(
            cin, cout, 3, stride=2, padding=1, output_padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.upsample_conv
        return conv_transpose2d(x, c.weight, c.bias, stride=2, padding=1,
                                output_padding=1)


class InstanceNorm(nn.Module):
    """Affine instance norm with the ``weight``/``bias`` keys of
    ``nn.InstanceNorm2d(affine=True)``; ReLU fuses into the same pass."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x: torch.Tensor, relu: bool = False) -> torch.Tensor:
        return instance_norm(x, self.weight, self.bias, relu=relu)


class ResidualBlock(nn.Module):
    def __init__(self, c: int = 256):
        super().__init__()
        self.conv1 = ConvLayer(c, c, 3)
        self.in1 = InstanceNorm(c)
        self.conv2 = ConvLayer(c, c, 3)
        self.in2 = InstanceNorm(c)

    def forward(self, x: torch.Tensor,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``keep``: an (N, C, 1, 1) bool Dropout2d mask, or None."""
        y = self.in1(self.conv1(x), relu=True)
        if keep is not None:
            y = torch.where(keep, y / (1.0 - DROPOUT_RATE),
                            torch.zeros((), dtype=y.dtype, device=y.device)).to(y.dtype)
        return x + self.in2(self.conv2(y))


class TransformerNet(nn.Module):
    """The single-style stylizer; registration order follows the reference
    (conv1, norm1, conv2, norm2, res_blocks, up1, norm3, up2, norm4,
    final_conv), so ``state_dict()`` keys come out in the reference's order."""

    def __init__(self):
        super().__init__()
        self.conv1 = ConvLayer(3, 64, 9, stride=2)
        self.norm1 = InstanceNorm(64)
        self.conv2 = ConvLayer(64, 256, 3, stride=2)
        self.norm2 = InstanceNorm(256)
        self.res_blocks = nn.ModuleList(
            ResidualBlock(256) for _ in range(NUM_RES_BLOCKS))
        self.up1 = UpsampleConv(256, 64)
        self.norm3 = InstanceNorm(64)
        self.up2 = UpsampleConv(64, 32)
        self.norm4 = InstanceNorm(32)
        self.final_conv = ConvLayer(32, 3, 9)

    def forward(self, x: torch.Tensor,
                precision: Precision = Precision.f32(), *,
                generator: Optional[torch.Generator] = None,
                dropout: bool = True) -> torch.Tensor:
        """NHWC in, NHWC out (same dtype). H and W must be multiples of 4
        for an exact round trip. Dropout runs in training mode with
        ``dropout``, its masks drawn from ``generator`` (None: the default
        generator of x's device)."""
        in_dtype = x.dtype
        h = x.permute(0, 3, 1, 2).to(precision.compute_dtype)
        h = h.contiguous(memory_format=torch.channels_last)
        h = self.norm1(self.conv1(h), relu=True)
        h = self.norm2(self.conv2(h), relu=True)
        drop = self.training and dropout
        for block in self.res_blocks:
            keep = None
            if drop:
                u = torch.rand((h.shape[0], h.shape[1], 1, 1), generator=generator,
                               device=h.device)
                keep = u < 1.0 - DROPOUT_RATE
            h = block(h, keep)
        h = self.norm3(self.up1(h), relu=True)
        h = self.norm4(self.up2(h), relu=True)
        out = self.final_conv(h)
        return out.permute(0, 2, 3, 1).to(in_dtype)
