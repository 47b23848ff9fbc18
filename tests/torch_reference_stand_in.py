"""A stand-in for the reference repository's ``models/model.py``, for
``fnst-parity`` where no reference checkout exists.

``StyleTransferNet`` is a plain ``nn.Module`` in the reference ``.pth``
layout (the key names of ``fast_neural_style_transfer_tpu_torch/models/
transformer.py``), NCHW in and out, built from stock torch layers
(``nn.ReflectionPad2d``, ``nn.Conv2d``, ``nn.InstanceNorm2d(affine=True)``,
``nn.ConvTranspose2d``) and independent of both packages, so the parity
tool holds the port's CUDA path against it. It imports only torch.
``write_reference_repo(root)`` lays this file out as
``<root>/models/model.py`` and returns ``root``.
"""

import os
import shutil

from torch import nn


class ConvLayer(nn.Module):
    def __init__(self, cin, cout, k, stride=1):
        super().__init__()
        self.pad = nn.ReflectionPad2d(k // 2)
        self.conv = nn.Conv2d(cin, cout, k, stride=stride)

    def forward(self, x):
        return self.conv(self.pad(x))


class UpsampleConvLayer(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.upsample_conv = nn.ConvTranspose2d(cin, cout, 3, stride=2, padding=1,
                                                output_padding=1)

    def forward(self, x):
        return self.upsample_conv(x)


class ResidualBlock(nn.Module):
    def __init__(self, c=256):
        super().__init__()
        self.conv1 = ConvLayer(c, c, 3)
        self.in1 = nn.InstanceNorm2d(c, affine=True)
        self.dropout = nn.Dropout2d(0.1)
        self.conv2 = ConvLayer(c, c, 3)
        self.in2 = nn.InstanceNorm2d(c, affine=True)

    def forward(self, x):
        y = self.dropout(nn.functional.relu(self.in1(self.conv1(x))))
        return x + self.in2(self.conv2(y))


class StyleTransferNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = ConvLayer(3, 64, 9, stride=2)
        self.norm1 = nn.InstanceNorm2d(64, affine=True)
        self.conv2 = ConvLayer(64, 256, 3, stride=2)
        self.norm2 = nn.InstanceNorm2d(256, affine=True)
        self.res_blocks = nn.Sequential(*[ResidualBlock(256) for _ in range(5)])
        self.up1 = UpsampleConvLayer(256, 64)
        self.norm3 = nn.InstanceNorm2d(64, affine=True)
        self.up2 = UpsampleConvLayer(64, 32)
        self.norm4 = nn.InstanceNorm2d(32, affine=True)
        self.final_conv = ConvLayer(32, 3, 9)

    def forward(self, x):
        relu = nn.functional.relu
        h = relu(self.norm1(self.conv1(x)))
        h = relu(self.norm2(self.conv2(h)))
        h = self.res_blocks(h)
        h = relu(self.norm3(self.up1(h)))
        h = relu(self.norm4(self.up2(h)))
        return self.final_conv(h)


def write_reference_repo(root):
    """``<root>/models/model.py``, a copy of this file; returns ``root``."""
    os.makedirs(os.path.join(root, "models"), exist_ok=True)
    shutil.copyfile(os.path.abspath(__file__), os.path.join(root, "models", "model.py"))
    return str(root)
