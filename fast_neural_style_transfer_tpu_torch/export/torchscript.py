"""TorchScript export of the stylizer (the JAX package's
``export/torchscript.py``; the reference traces its net into
``model_traced.pt``).

The port's own forward cannot be traced: its instance norm calls the
hand-written kernel through ``ctypes`` with raw pointers, which the tracer
does not see. So the exported forward is written in plain torch ops,
``F.pad(reflect)``, ``F.conv2d``, ``F.conv_transpose2d`` and
``F.instance_norm``, over the weights of a ``TransformerNet`` held as a
submodule: they are parameters of the traced module, not constants of its
graph, so ``torch.jit.load(path, map_location=...)`` runs the archive on
either device. Tracing runs on the CPU, so the archive is the same
whichever device the caller works on. NCHW float32 in and out, eval-mode
semantics (no dropout).
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fast_neural_style_transfer_tpu_torch.models.transformer import (
    TransformerNet,
    layer_walk,
    require_single_style,
)


class PlainStylizer(nn.Module):
    """The stylizer's eval forward in plain torch ops, NCHW in and out: its
    ``layer_walk`` over the weights of ``self.net``."""

    def __init__(self, state_dict):
        super().__init__()
        require_single_style(state_dict, "export_torchscript")
        self.net = TransformerNet()
        self.net.load_state_dict(state_dict, strict=True)
        self.net.eval().requires_grad_(False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        layers = self.net.layers

        def conv(name, h, stride):
            c = layers[name]
            k = c.weight.shape[-1]
            return F.conv2d(F.pad(h, [k // 2] * 4, mode="reflect"), c.weight, c.bias,
                            stride=stride)

        def up(name, h):
            c = layers[name]
            return F.conv_transpose2d(h, c.weight, c.bias, stride=2, padding=1,
                                      output_padding=1)

        def inorm(name, h, relu):
            n = layers[name]
            h = F.instance_norm(h, weight=n.weight, bias=n.bias, eps=1e-5)
            return F.relu(h) if relu else h

        return layer_walk(x, conv=conv, up=up, inorm=inorm)


def export_torchscript(state_dict, path: str, *, example_hw: int = 256) -> str:
    """Trace the stylizer (a single-style state_dict) on the CPU to a
    ``.pt`` archive (the reference's ``model_traced.pt``)."""
    module = PlainStylizer({k: v.detach().cpu() for k, v in state_dict.items()})
    example = torch.rand(1, 3, example_hw, example_hw,
                         generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        traced = torch.jit.trace(module, example, check_trace=False)
    traced.save(path)
    return path


@torch.inference_mode()
def check_torchscript(path: str, state_dict, *,
                      device: Optional[Union[str, torch.device]] = None,
                      hw: int = 64, seed: int = 0) -> float:
    """Load the archive on ``device`` (None: the card) and run it on a
    seeded network-space batch (``hw`` a multiple of 4) beside the port's
    f32 ``Stylizer`` there; returns the largest absolute difference
    (network space)."""
    from fast_neural_style_transfer_tpu_torch.infer.stylize import Stylizer

    sty = Stylizer(state_dict, precision="f32", bucket_multiple=4, device=device)
    x = np.random.default_rng(seed).standard_normal((1, hw, hw, 3)).astype(np.float32)
    module = torch.jit.load(path, map_location=sty.device)
    got = module(torch.from_numpy(x).to(sty.device).permute(0, 3, 1, 2))
    want = torch.from_numpy(sty(x)).to(sty.device)
    return float((got.permute(0, 2, 3, 1) - want).abs().max())
