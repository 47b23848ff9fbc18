"""The reference stylizer (Johnson et al. 2016, arXiv:1603.08155, with
instance norm, arXiv:1607.08022) in plain torch, float32, at the reference
``StyleTransferNet``'s widths and parameter names:

    conv1 3->64 k9 s2, norm1, ReLU; conv2 64->256 k3 s2, norm2, ReLU;
    5 residual blocks of 256 (conv k3, IN, ReLU, Dropout2d(0.1), conv k3,
    IN, + input); up1 ConvTranspose 256->64 k3 s2 p1 op1, norm3, ReLU;
    up2 ConvTranspose 64->32, norm4, ReLU; final_conv 32->3 k9.

Every convolution but the transposed ones pads by reflection. The
training step follows with the frozen VGG19 losses: ``reference/train.py``.
"""

import torch
import torch.nn.functional as F

from reference.common import instance_norm, reflect_conv

NUM_RES_BLOCKS = 5
DROPOUT_RATE = 0.1
CONVS = [("conv1.conv", 3, 64, 9), ("conv2.conv", 64, 256, 3)] + [
    (f"res_blocks.{i}.conv{j}.conv", 256, 256, 3)
    for i in range(NUM_RES_BLOCKS) for j in (1, 2)] + [("final_conv.conv", 32, 3, 9)]
UPS = [("up1.upsample_conv", 256, 64), ("up2.upsample_conv", 64, 32)]
NORMS = [("norm1", 64), ("norm2", 256)] + [
    (f"res_blocks.{i}.in{j}", 256) for i in range(NUM_RES_BLOCKS) for j in (1, 2)] + [
    ("norm3", 64), ("norm4", 32)]


def param_spec():
    """(name, shape, init, fan_in) of every parameter. Convolutions take
    PyTorch's default initialization, uniform within 1/sqrt(fan_in) for the
    weights and the biases; instance-norm affines are drawn about (1, 0),
    as a trained net's are spread."""
    spec = []
    for name, cin, cout, k in CONVS:
        spec += [(f"{name}.weight", (cout, cin, k, k), "uniform", cin * k * k),
                 (f"{name}.bias", (cout,), "uniform", cin * k * k)]
    for name, cin, cout in UPS:  # ConvTranspose2d: IOHW, fan_in from dim 1
        spec += [(f"{name}.weight", (cin, cout, 3, 3), "uniform", cout * 9),
                 (f"{name}.bias", (cout,), "uniform", cout * 9)]
    for name, c in NORMS:
        spec += [(f"{name}.weight", (c,), "gamma", 0), (f"{name}.bias", (c,), "beta", 0)]
    return spec


def dropout_masks(n: int, generator: torch.Generator, device):
    """One forward's five Dropout2d keep-masks, (N, 256, 1, 1) each, drawn in
    block order from ``generator`` as uniforms below 1 - rate."""
    return [torch.rand((n, 256, 1, 1), generator=generator, device=device) < 1.0 - DROPOUT_RATE
            for _ in range(NUM_RES_BLOCKS)]


def forward(p, x, keeps=None, conv=F.conv2d, conv_transpose=F.conv_transpose2d):
    """NCHW network-space float32 in and out. ``keeps``: the five dropout
    masks of a training forward, or None. ``conv`` / ``conv_transpose``:
    the convolutions (the int8 control passes its own)."""
    def c(h, name, stride=1):
        return reflect_conv(h, p[name + ".weight"], p[name + ".bias"], stride, conv)

    def n(h, name, relu):
        return instance_norm(h, p[name + ".weight"], p[name + ".bias"], relu)

    def up(h, name):
        return conv_transpose(h, p[name + ".weight"], p[name + ".bias"], stride=2,
                              padding=1, output_padding=1)

    h = n(c(x, "conv1.conv", 2), "norm1", True)
    h = n(c(h, "conv2.conv", 2), "norm2", True)
    for i in range(NUM_RES_BLOCKS):
        b = f"res_blocks.{i}"
        y = n(c(h, f"{b}.conv1.conv"), f"{b}.in1", True)
        if keeps is not None:
            y = torch.where(keeps[i], y / (1.0 - DROPOUT_RATE), torch.zeros((), device=y.device))
        h = h + n(c(y, f"{b}.conv2.conv"), f"{b}.in2", False)
    h = n(up(h, "up1.upsample_conv"), "norm3", True)
    h = n(up(h, "up2.upsample_conv"), "norm4", True)
    return c(h, "final_conv.conv")
