"""Frozen VGG19 feature extractor for the perceptual losses, with
name-addressed taps (the JAX package's ``models/vgg.py``).

Taps are asked for by layer name (``relu1_2``, ``conv4_2``, ``pool3``...)
and come back in the order asked, NHWC like the JAX package's. The walk runs
each conv once and stops at the deepest requested tap, so the default
content tap ``relu4_2`` never computes block 5. ``conv4_2`` is the
pre-activation output, as in the reference's actual slicing.

Inside, activations are (N, C, H, W) in ``torch.channels_last`` memory
format (physically NHWC; the permutes at the edges are free). Convs are
``ops/conv.py::conv2d_same``: cuDNN forward and backward, except the input
gradient of ``conv1_1`` (3 -> 64), which is the hand-written kernel of
``ops/cuda_conv.py``. Weights are parameters with ``requires_grad=False``;
gradients flow through to the input, never into the weights.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import torch
from torch import nn

from fast_neural_style_transfer_tpu_torch.core.dtypes import Precision
from fast_neural_style_transfer_tpu_torch.ops.conv import conv2d_same, max_pool2d

# (name, out channels); 0 marks a 2x2 / 2 max pool
_CFG: List[Tuple[str, int]] = [
    ("conv1_1", 64), ("conv1_2", 64),
    ("pool1", 0),
    ("conv2_1", 128), ("conv2_2", 128),
    ("pool2", 0),
    ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), ("conv3_4", 256),
    ("pool3", 0),
    ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512), ("conv4_4", 512),
    ("pool4", 0),
    ("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512), ("conv5_4", 512),
]

# The reference's actual 5 taps, in forward order.
VGG19_TAPS: Tuple[str, ...] = ("relu1_2", "relu2_2", "relu3_3", "conv4_2", "relu4_3")
DEFAULT_TAPS = VGG19_TAPS

CONV_NAMES: Tuple[str, ...] = tuple(n for n, c in _CFG if c)

# torchvision vgg19.features index of each conv, for .pth key conversion
TORCHVISION_CONV_INDEX: Dict[str, int] = {
    "conv1_1": 0, "conv1_2": 2,
    "conv2_1": 5, "conv2_2": 7,
    "conv3_1": 10, "conv3_2": 12, "conv3_3": 14, "conv3_4": 16,
    "conv4_1": 19, "conv4_2": 21, "conv4_3": 23, "conv4_4": 25,
    "conv5_1": 28, "conv5_2": 30, "conv5_3": 32, "conv5_4": 34,
}

# the first conv, whose input gradient runs on the hand-written kernel
SMALL_CIN_CONV = "conv1_1"


def _addressable_names() -> Tuple[str, ...]:
    names = []
    for name, c in _CFG:
        names.append(name)
        if c:
            names.append("relu" + name[4:])
    return tuple(names)


ADDRESSABLE = _addressable_names()


def conv_shapes() -> List[Tuple[str, int, int]]:
    """(name, C_in, C_out) of every conv, in forward order."""
    out, cin = [], 3
    for name, cout in _CFG:
        if cout:
            out.append((name, cin, cout))
            cin = cout
    return out


class VGG19Features(nn.Module):
    """VGG19 ``features`` with name-addressed taps; parameter names are
    ``<conv>.weight`` (OIHW) and ``<conv>.bias``."""

    def __init__(self):
        super().__init__()
        for name, cin, cout in conv_shapes():
            self.add_module(name, nn.Conv2d(cin, cout, 3, padding=1))
        self.requires_grad_(False)

    def forward(
        self,
        x: torch.Tensor,
        taps: Sequence[str] = DEFAULT_TAPS,
        *,
        precision: Precision = Precision.f32(),
    ) -> List[torch.Tensor]:
        """NHWC in; the requested activations, NHWC, in tap order."""
        return tap_walk(self, x, taps, conv_fn=_conv_same, pool_fn=max_pool2d,
                        precision=precision)


def _conv_same(name: str, conv: nn.Conv2d, h: torch.Tensor) -> torch.Tensor:
    return conv2d_same(h, conv.weight, conv.bias,
                       small_cin_kernel=name == SMALL_CIN_CONV)


def tap_walk(
    vgg: nn.Module,
    x: torch.Tensor,
    taps: Sequence[str],
    *,
    conv_fn: Callable[[str, nn.Conv2d, torch.Tensor], torch.Tensor],
    pool_fn: Callable[[torch.Tensor], torch.Tensor],
    precision: Precision = Precision.f32(),
) -> List[torch.Tensor]:
    """The VGG19 walk with its conv and pool supplied (the JAX package's
    ``tap_walk``): ``conv_fn(name, conv, h)`` and ``pool_fn(h)`` on (N, C,
    H, W) channels_last activations; the height-sharded forward
    (``models/spatial.py``) passes halo-exchanging ones. NHWC in; the
    requested activations, NHWC, in tap order."""
    for t in taps:
        if t not in ADDRESSABLE:
            raise ValueError(f"unknown VGG19 tap {t!r}; valid: {ADDRESSABLE}")
    wanted = set(taps)
    deepest = max(ADDRESSABLE.index(t) for t in taps)

    acts: Dict[str, torch.Tensor] = {}
    h = x.permute(0, 3, 1, 2).to(precision.compute_dtype)
    h = h.contiguous(memory_format=torch.channels_last)
    pos = -1
    for name, cout in _CFG:
        if pos >= deepest:
            break
        if cout:
            h = conv_fn(name, getattr(vgg, name), h)
            pos += 1
            if name in wanted:
                acts[name] = h
            if pos >= deepest:
                break
            rname = "relu" + name[4:]
            h = torch.relu(h)
            pos += 1
            if rname in wanted:
                acts[rname] = h
        else:
            h = pool_fn(h)
            pos += 1
            if name in wanted:
                acts[name] = h
    return [acts[t].permute(0, 2, 3, 1) for t in taps]
