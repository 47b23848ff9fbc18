"""AdaIN decoder interchange with PyTorch and the TorchScript export of the
whole arbitrary-style pipeline (the JAX package's ``export/torch_adain.py``).

The decoder of the public AdaIN implementations is a Sequential of
ReflectionPad2d(1) + Conv2d(3x3) + ReLU with nearest x2 Upsample at the
stage boundaries, the layout of the port's ``models/adain.py::AdaINDecoder``
itself, so ``save_torch_adain_decoder`` writes a state_dict that loads
strict into ``build_torch_decoder()`` and into those implementations, and
``load_torch_adain_decoder`` reads any of them by conv order
(``models/adain.py::decoder_state_dict_from_torch``).

``export_adain_torchscript`` traces the two-input pipeline, VGG19 to
relu4_1 on content and style, AdaIN, the decoder, in plain torch ops with
the weights as parameters of the traced module (the port's kernels, called
through ``ctypes``, cannot be traced), so the archive runs on either device.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from fast_neural_style_transfer_tpu_torch.models.adain import (
    ENCODE_TAP,
    AdaINDecoder,
    load_decoder,
)
from fast_neural_style_transfer_tpu_torch.models.vgg import _CFG as VGG_CFG


def build_torch_decoder() -> nn.Sequential:
    """The decoder as a plain ``nn.Sequential`` (NCHW forward), with the
    layers and keys of ``AdaINDecoder``."""
    return nn.Sequential(*AdaINDecoder())


def save_torch_adain_decoder(decoder_sd: Mapping[str, torch.Tensor], path: str) -> str:
    """``AdaINDecoder``'s state_dict -> a ``.pth`` state_dict that loads
    strict into ``build_torch_decoder()`` (every shape checked here)."""
    dec = build_torch_decoder()
    dec.load_state_dict(decoder_sd, strict=True)
    torch.save(dec.state_dict(), path)
    return path


def load_torch_adain_decoder(path: str):
    """A torch ``.pth``/``.pt`` AdaIN decoder (bare, or under a common
    wrapper key) -> ``AdaINDecoder``'s state_dict, by conv order."""
    if not path.endswith((".pth", ".pt", ".bin")):
        raise ValueError(f"{path}: expected a torch .pth/.pt/.bin decoder")
    return load_decoder(path)


def _encoder_convs(vgg_sd: Mapping[str, torch.Tensor]) -> nn.ModuleList:
    """VGG19's convs up to the AdaIN tap (relu4_1) as 3x3 Conv2d modules."""
    convs, cin = nn.ModuleList(), 3
    for name, cout in VGG_CFG:
        if not cout:
            continue
        conv = nn.Conv2d(cin, cout, 3, padding=1)
        conv.load_state_dict({"weight": vgg_sd[f"{name}.weight"],
                              "bias": vgg_sd[f"{name}.bias"]})
        convs.append(conv)
        cin = cout
        if "relu" + name[4:] == ENCODE_TAP:
            return convs
    raise AssertionError(f"{ENCODE_TAP} not reached in the VGG config")


class PlainAdaIN(nn.Module):
    """(content, style) NCHW network-space -> stylized NCHW: VGG19 to
    relu4_1 on both, AdaIN (eps 1e-5, biased variance), ``alpha`` blend
    with the content feature, the decoder."""

    def __init__(self, decoder_sd, vgg_sd, alpha: float = 1.0):
        super().__init__()
        self.encoder = _encoder_convs({k: v.detach().cpu() for k, v in vgg_sd.items()})
        self.decoder = build_torch_decoder()
        self.decoder.load_state_dict({k: v.detach().cpu() for k, v in decoder_sd.items()},
                                     strict=True)
        self.alpha = float(alpha)
        self.eval().requires_grad_(False)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        convs = iter(self.encoder)
        for name, cout in VGG_CFG:
            if cout:
                x = F.relu(next(convs)(x))
                if "relu" + name[4:] == ENCODE_TAP:
                    return x
            else:
                x = F.max_pool2d(x, 2, 2)
        return x

    @staticmethod
    def _stats(f: torch.Tensor):
        mu = f.mean(dim=(2, 3), keepdim=True)
        var = ((f - mu) ** 2).mean(dim=(2, 3), keepdim=True)
        return mu, torch.sqrt(var + 1e-5)

    def forward(self, content: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        cf, sf = self.encode(content), self.encode(style)
        mu_c, sd_c = self._stats(cf)
        mu_s, sd_s = self._stats(sf)
        t = sd_s * (cf - mu_c) / sd_c + mu_s
        t = self.alpha * t + (1.0 - self.alpha) * cf
        return self.decoder(t)


def export_adain_torchscript(decoder_sd, vgg_sd, path: str, *, alpha: float = 1.0,
                             example_hw: int = 64) -> str:
    """Trace the full arbitrary-style pipeline on the CPU to a two-input
    ``.pt`` (content, style; NCHW, ImageNet-normalized; H and W multiples
    of 8), ``alpha`` baked in."""
    module = PlainAdaIN(decoder_sd, vgg_sd, alpha)
    g = torch.Generator().manual_seed(0)
    example = (torch.randn(1, 3, example_hw, example_hw, generator=g),
               torch.randn(1, 3, example_hw, example_hw, generator=g))
    with torch.no_grad():
        traced = torch.jit.trace(module, example, check_trace=False)
    traced.save(path)
    return path
