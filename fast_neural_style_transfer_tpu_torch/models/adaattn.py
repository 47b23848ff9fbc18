"""AdaAttN (Liu et al., "AdaAttN: Revisit Attention Mechanism in Arbitrary
Neural Style Transfer", ICCV 2021, arXiv:2108.03647): attention-weighted
mean and standard deviation of the style's features at relu3_1, relu4_1 and
relu5_1, with keys built from every shallower VGG level, decoded by a
skip-connected decoder.

At each site l (the official code's ``--shallow_layer --skip_connection_3``):

- keys ``K_c = cat_{i <= l} norm(nearest(F_c^i -> the grid of F_c^l))``, and
  ``K_s`` the same from the style: 64 + 128 + 256 = 448 channels at
  relu3_1, 960 at relu4_1, 1472 at relu5_1; ``norm`` is instance norm
  without affine (biased variance, eps 1e-5; on a card the IN forward
  kernel, ``ops/norm.py``);
- ``Q = f(K_c)``, ``K = g(K_s)``, ``V = h(F_s^l)``, each a 1x1 conv;
- ``A = softmax(Q^T K)``, unscaled; ``M = A V``; ``S = sqrt(relu(A V^2 -
  M^2))``; ``out_l = S * norm(F_c^l) + M``, where ``norm(F_c^l)`` is the
  last channels of ``K_c`` (``ops/cuda_moment_attention.py``: one kernel
  launch a site and batch at bf16 on a card);
- at relu3_1 a style of more than 4096 positions keeps the 4096 drawn by a
  seeded permutation (``torch.randperm`` on the CPU under the
  configuration's seed, 6666 as the official code's), 65536 at the others.

``T = merge_conv(reflect_pad(out_4 + up2(out_5)))`` (3x3, 512 -> 512); the
decoder runs a reflect-padded 3x3 conv 512 -> 256 and a ReLU on T, upsamples
x2, concatenates ``out_3`` on the channels, then the AdaIN decoder's convs
from its second on, the first taking 512 channels. The output is [0, 1]
pixels (callers clamp); the encoder is the port's VGG19 on the
ImageNet-normalized image.

The modules carry the official code's names (``models/networks.py``:
``AdaAttN.f/g/h``, ``Transformer.attn_adain_4_1/attn_adain_5_1/merge_conv``,
``Decoder.decoder_layer_1/2`` as ``nn.Sequential``), so ``load_adaattn``
takes its three state dicts (``latest_net_adaattn_3.pth``,
``latest_net_transformer.pth``, ``latest_net_decoder.pth``) strictly, under
``adaattn_3.``, ``transformer.`` and ``decoder.``. What depends on the style
alone (the sampled ``g(K_s)`` and ``h(F_s^l)`` of each site) is
``style_cache``'s, computed once per style.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, List, Mapping, NamedTuple, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from fast_neural_style_transfer_tpu_torch.core.dtypes import Precision
from fast_neural_style_transfer_tpu_torch.models.stytr2 import LaunchCounter, _read
from fast_neural_style_transfer_tpu_torch.ops.conv import reflect_conv2d
from fast_neural_style_transfer_tpu_torch.ops.cuda_moment_attention import (
    MomentValues,
    moment_attention,
    prepare_values,
)
from fast_neural_style_transfer_tpu_torch.ops.norm import instance_norm

# the VGG19 levels the keys read, and the three attention sites
LEVELS = ("relu1_1", "relu2_1", "relu3_1", "relu4_1", "relu5_1")
WIDTHS = (64, 128, 256, 512, 512)
SITES = (2, 3, 4)  # relu3_1, relu4_1, relu5_1 as indices of LEVELS
MAX_SAMPLE = {2: 64 * 64, 3: 256 * 256, 4: 256 * 256}
SEED = 6666  # the official model's seed of the relu3_1 permutation
GRID = 16  # relu5_1's stride: image sides are multiples of it
# decoder_layer_2 after the skip concatenation: (out channels, upsample
# before), all 3x3 reflect convs, a ReLU after all but the last; the AdaIN
# decoder's convs from its second on
LAYER_2: tuple = ((256, False), (256, False), (256, False), (128, False),
                  (128, True), (64, False), (64, True), (3, False))

StateDict = Dict[str, torch.Tensor]


def key_width(site: int) -> int:
    return sum(WIDTHS[:site + 1])


class AdaAttNModule(nn.Module):
    """The official ``AdaAttN``: f and g (1x1, key width), h (1x1, value
    width)."""

    def __init__(self, in_planes: int, key_planes: int):
        super().__init__()
        self.f = nn.Conv2d(key_planes, key_planes, 1)
        self.g = nn.Conv2d(key_planes, key_planes, 1)
        self.h = nn.Conv2d(in_planes, in_planes, 1)


class Transformer(nn.Module):
    """The official ``Transformer`` (shallow-layer keys): the relu4_1 and
    relu5_1 attentions and the 3x3 merge conv."""

    def __init__(self):
        super().__init__()
        self.attn_adain_4_1 = AdaAttNModule(512, key_width(3))
        self.attn_adain_5_1 = AdaAttNModule(512, key_width(4))
        self.merge_conv = nn.Conv2d(512, 512, 3)


def _decoder_layer_2() -> nn.Sequential:
    layers, cin = [], 512
    for cout, up in LAYER_2:
        if up:
            layers.append(nn.Upsample(scale_factor=2, mode="nearest"))
        layers += [nn.ReflectionPad2d(1), nn.Conv2d(cin, cout, 3), nn.ReLU()]
        cin = cout
    return nn.Sequential(*layers[:-1])  # no ReLU after the last conv


class Decoder(nn.Module):
    """The official ``Decoder(skip_connection_3=True)``."""

    def __init__(self):
        super().__init__()
        self.decoder_layer_1 = nn.Sequential(
            nn.ReflectionPad2d(1), nn.Conv2d(512, 256, 3), nn.ReLU(),
            nn.Upsample(scale_factor=2, mode="nearest"))
        self.decoder_layer_2 = _decoder_layer_2()

    def convs(self) -> List[nn.Conv2d]:
        return [m for m in self.modules() if isinstance(m, nn.Conv2d)]


class SiteCache(NamedTuple):
    """One site's share of a style: the sampled ``g(K_s)`` (Nk, Dqk) in the
    compute dtype and ``h(F_s^l)``'s ``prepare_values``."""

    keys: torch.Tensor
    values: MomentValues


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _conv1x1(x: torch.Tensor, conv: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    """A 1x1 conv of (..., C) rows as a matrix product, in ``dtype``."""
    w = conv.weight.reshape(conv.weight.shape[0], -1)
    return F.linear(x.to(dtype), w.to(dtype), conv.bias.to(dtype))


def build_keys(feats: Sequence[torch.Tensor], site: int) -> torch.Tensor:
    """``get_key``: the NHWC levels (relu1_1 first) up to ``site``, each
    nearest-downsampled to the site's grid, instance-normalized, and
    concatenated on the channels -> (B, h, w, key width), contiguous."""
    h, w = feats[site].shape[1:3]
    parts = []
    for i in range(site + 1):
        x = _nchw(feats[i][:, ::feats[i].shape[1] // h, ::feats[i].shape[2] // w])
        ones = torch.ones(x.shape[1], device=x.device)
        parts.append(_nhwc(instance_norm(x, ones, torch.zeros_like(ones))))
    return torch.cat(parts, dim=-1)


class AdaAttN(nn.Module):
    """``adaattn_3`` (relu3_1), ``transformer`` (relu4_1, relu5_1, merge) and
    ``decoder``. The stages (``keys``, ``attend``, ``decode``) are separate
    calls so that a caller can time each; ``counter`` counts attention
    calls."""

    def __init__(self):
        super().__init__()
        self.adaattn_3 = AdaAttNModule(256, key_width(2))
        self.transformer = Transformer()
        self.decoder = Decoder()
        self.counter = LaunchCounter()

    def site_module(self, site: int) -> AdaAttNModule:
        return {2: self.adaattn_3, 3: self.transformer.attn_adain_4_1,
                4: self.transformer.attn_adain_5_1}[site]

    def style_cache(self, feats: Sequence[torch.Tensor],
                    precision: Precision) -> Dict[int, SiteCache]:
        """The style's VGG levels (one image, NHWC) -> each site's cache.
        The projections run in float32 from the features; a site with more
        positions than ``MAX_SAMPLE`` keeps those a CPU permutation seeded
        with ``SEED`` draws first."""
        if feats[0].shape[0] != 1:
            raise ValueError(f"one style image, not {feats[0].shape[0]}")
        dtype = precision.compute_dtype
        cache = {}
        for site in SITES:
            mod = self.site_module(site)
            key = build_keys(feats, site).flatten(1, 2)[0]
            k = _conv1x1(key.float(), mod.g, torch.float32)
            v = _conv1x1(feats[site].flatten(1, 2)[0].float(), mod.h, torch.float32)
            if k.shape[0] > MAX_SAMPLE[site]:
                gen = torch.Generator().manual_seed(SEED)
                idx = torch.randperm(k.shape[0], generator=gen)[:MAX_SAMPLE[site]]
                idx = idx.to(k.device)
                k, v = k[idx], v[idx]
            cache[site] = SiteCache(k.to(dtype).contiguous(), prepare_values(v, dtype))
        return cache

    def keys(self, feats: Sequence[torch.Tensor], precision: Precision):
        """The content's keys and queries of each site: {site: (K_c (B, N,
        Dqk), Q (B, N, Dqk))}, in the compute dtype."""
        dtype = precision.compute_dtype
        out = {}
        for site in SITES:
            key = build_keys(feats, site).flatten(1, 2).to(dtype)
            out[site] = (key, _conv1x1(key, self.site_module(site).f, dtype))
        return out

    def attend(self, keys, style: Mapping[int, SiteCache],
               feats: Sequence[torch.Tensor]) -> Dict[int, torch.Tensor]:
        """Each site's ``S * norm(F_c^l) + M``, NHWC at its grid."""
        out = {}
        for site in SITES:
            key, q = keys[site]
            dv = WIDTHS[site]
            b, h, w, _ = feats[site].shape
            o = moment_attention(q, style[site].keys, style[site].values,
                                 key[..., key.shape[-1] - dv:])
            self.counter.attention_launches += 1
            out[site] = o.view(b, h, w, dv)
        return out

    def decode(self, outs: Mapping[int, torch.Tensor], precision: Precision) -> torch.Tensor:
        """The merge and the decoder -> [0, 1]-space pixels (B, H, W, 3),
        unclamped."""
        dtype = precision.compute_dtype
        x5 = F.interpolate(_nchw(outs[4].to(dtype)), scale_factor=2, mode="nearest")
        t = (_nchw(outs[3].to(dtype)) + x5).contiguous(memory_format=torch.channels_last)
        mc = self.transformer.merge_conv
        t = reflect_conv2d(t, mc.weight, mc.bias)
        convs = self.decoder.convs()
        y = reflect_conv2d(t, convs[0].weight, convs[0].bias)
        y = F.interpolate(torch.relu(y), scale_factor=2, mode="nearest")
        y = torch.cat([y, _nchw(outs[2].to(dtype))], dim=1)
        y = y.contiguous(memory_format=torch.channels_last)
        # each later conv's ReLU, and the x2 upsample after it, are read
        # through by the next conv's reflect pad
        for i, ((_, up), conv) in enumerate(zip(LAYER_2, convs[1:])):
            y = reflect_conv2d(y, conv.weight, conv.bias, relu=i > 0, upsample=2 if up else 1)
        return _nhwc(y)


# -- weights ------------------------------------------------------------------

PARTS = ("adaattn_3", "transformer", "decoder")


def _expected_keys() -> Dict[str, set]:
    with torch.device("meta"):
        model = AdaAttN()
    return {part: set(getattr(model, part).state_dict()) for part in PARTS}


def load_adaattn(adaattn_3, transformer, decoder) -> StateDict:
    """The official checkpoints' three state dicts (mappings or ``.pth``
    paths) -> ``AdaAttN``'s state_dict. Each must hold exactly its part's
    keys (``f/g/h.weight|bias``; ``attn_adain_4_1.*``, ``attn_adain_5_1.*``,
    ``merge_conv.*``; ``decoder_layer_1.1.*``, ``decoder_layer_2.{1, 4, 7,
    10, 14, 17, 21, 24}.*``), a ``module.`` prefix (a saved
    ``DataParallel``) dropped. Shapes are checked when the state_dict is
    loaded."""
    expected = _expected_keys()
    out: StateDict = {}
    for part, obj in zip(PARTS, (adaattn_3, transformer, decoder)):
        sd = {k[len("module."):] if k.startswith("module.") else k: v
              for k, v in _read(obj).items()}
        got = set(sd)
        missing, unexpected = expected[part] - got, got - expected[part]
        if missing or unexpected:
            raise ValueError(f"AdaAttN {part} state_dict: missing {sorted(missing)[:6]}, "
                             f"unexpected {sorted(unexpected)[:6]}")
        out.update({f"{part}.{k}": torch.as_tensor(v).float() for k, v in sd.items()})
    return out


def load_adaattn_checkpoint(path: Union[str, os.PathLike]) -> StateDict:
    """A directory holding the official ``<epoch>_net_adaattn_3.pth``,
    ``<epoch>_net_transformer.pth`` and ``<epoch>_net_decoder.pth`` (the
    release's ``latest_net_*``), one each."""
    files = []
    for part in PARTS:
        found = sorted(Path(path).glob(f"*net_{part}.pth"))
        if len(found) != 1:
            raise FileNotFoundError(f"{path}: want one *net_{part}.pth, found {len(found)}")
        files.append(found[0])
    return load_adaattn(*files)


def make_adaattn(state_dict: Mapping[str, torch.Tensor], device) -> AdaAttN:
    """An ``AdaAttN`` on ``device`` with ``state_dict`` loaded strictly, in
    eval mode."""
    model = AdaAttN()
    model.load_state_dict(state_dict, strict=True)
    return model.to(device, memory_format=torch.channels_last).eval()
