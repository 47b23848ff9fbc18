"""AdaAttN (Liu et al., ICCV 2021, arXiv:2108.03647) in plain torch,
float32, after the official code (github.com/Huage001/AdaAttN,
``models/networks.py`` and ``models/adaattn_model.py``, run with
``--shallow_layer --skip_connection_3``), line by line:

- ``get_key``: every VGG level up to the site, nearest-interpolated to the
  site's grid, ``mean_variance_norm``-ed, concatenated on the channels;
- ``AdaAttN.forward``: ``F = f(content_key)``, ``G = g(style_key)``, ``H =
  h(style)``; over ``max_sample`` style positions, those a permutation
  draws first; ``S = softmax(bmm(F^T, G))``; ``mean = bmm(S, H^T)``; ``std =
  sqrt(relu(bmm(S, (H^T)^2) - mean^2))``; ``std * mean_variance_norm(content)
  + mean``;
- ``Transformer.forward``: ``merge_conv(pad(attn_4_1 + up(attn_5_1)))``;
- ``Decoder.forward``: ``decoder_layer_1``, the concatenation with the
  relu3_1 attention, ``decoder_layer_2``.

The encoder is ``reference/vgg.py``'s VGG19 to relu5_1 on the
ImageNet-normalized image; the output is [0, 1] pixels. Parameters carry the
port's state_dict names: the official checkpoints' keys under ``adaattn_3.``,
``transformer.`` and ``decoder.``. Attention runs ``BLOCK_Q`` queries at a
time, so that a 512² image's scores fit.

Departures from the official code: ``mean_variance_norm`` with the biased
variance (instance norm's, the port's convention; the official ``var`` is
unbiased); the permutation drawn by ``torch.randperm`` on the CPU from a
``torch.Generator`` seeded with ``SEED``, where the official code seeds the
global generator with it (the same draw); the style encoded and sampled
once and shared by a batch of contents, where the official code pairs each
content with its own style; the output clamped to [0, 1] (the official
code clamps when it saves the image); the encoder's zero padding and
ImageNet normalization are the port's VGG19's, not ``vgg_normalised.pth``'s
reflect padding and 1x1 colour conv.

``fault`` plants one of the faults the cell's limit must catch:
"last_layer_keys" (the keys' shallower levels zeroed: the site's layer
alone), "no_std" (``out = mean_variance_norm(content) + mean``), "no_skip"
(the relu3_1 attention replaced by zeros before the decoder),
"other_permutation" (another draw at relu3_1)."""

import torch
import torch.nn.functional as F

from reference import vgg
from reference.common import IN_EPS, reflect_conv

LEVELS = ("relu1_1", "relu2_1", "relu3_1", "relu4_1", "relu5_1")
WIDTHS = (64, 128, 256, 512, 512)
# (parameter prefix, VGG level, max_sample) of the three attentions
SITES = (("adaattn_3.", 2, 64 * 64), ("transformer.attn_adain_4_1.", 3, 256 * 256),
         ("transformer.attn_adain_5_1.", 4, 256 * 256))
SEED = 6666
BLOCK_Q = 4096
FAULTS = ("last_layer_keys", "no_std", "no_skip", "other_permutation")
# decoder_layer_2's convs: (index in the Sequential, C_in, C_out, upsample before)
LAYER_2 = ((1, 512, 256, False), (4, 256, 256, False), (7, 256, 256, False),
           (10, 256, 128, False), (14, 128, 128, True), (17, 128, 64, False),
           (21, 64, 64, True), (24, 64, 3, False))


def param_spec():
    """(name, shape, init, fan_in) of every parameter: He-normal weights
    (the harness rescales the attentions' and the merge conv's to the
    official N(0, 0.02)), zero biases (the official ``init_net``'s)."""
    spec = []
    for pre, site, _ in SITES:
        dk, dv = sum(WIDTHS[:site + 1]), WIDTHS[site]
        for name, d in (("f", dk), ("g", dk), ("h", dv)):
            spec += [(f"{pre}{name}.weight", (d, d, 1, 1), "he_normal", d),
                     (f"{pre}{name}.bias", (d,), "zero", 0)]
    spec += [("transformer.merge_conv.weight", (512, 512, 3, 3), "he_normal", 512 * 9),
             ("transformer.merge_conv.bias", (512,), "zero", 0),
             ("decoder.decoder_layer_1.1.weight", (256, 512, 3, 3), "he_normal", 512 * 9),
             ("decoder.decoder_layer_1.1.bias", (256,), "zero", 0)]
    for idx, cin, cout, _ in LAYER_2:
        spec += [(f"decoder.decoder_layer_2.{idx}.weight", (cout, cin, 3, 3), "he_normal",
                  cin * 9),
                 (f"decoder.decoder_layer_2.{idx}.bias", (cout,), "zero", 0)]
    return spec


def last_conv():
    return "decoder.decoder_layer_2.24.weight", "decoder.decoder_layer_2.24.bias"


def mean_variance_norm(feat):
    mean = feat.mean(dim=(2, 3), keepdim=True)
    var = (feat - mean).square().mean(dim=(2, 3), keepdim=True)
    return (feat - mean) / torch.sqrt(var + IN_EPS)


def get_key(feats, last, fault=None):
    _, _, h, w = feats[last].shape
    results = []
    for i in range(last):
        k = mean_variance_norm(F.interpolate(feats[i], (h, w)))
        results.append(torch.zeros_like(k) if fault == "last_layer_keys" else k)
    results.append(mean_variance_norm(feats[last]))
    return torch.cat(results, dim=1)


def _conv1x1(p, name, x):
    return F.conv2d(x, p[name + ".weight"], p[name + ".bias"])


def encode(vgg_p, x):
    """The five VGG levels of a network-space NCHW batch."""
    out = vgg.features(vgg_p, x, LEVELS)
    return [out[t] for t in LEVELS]


def style_cache(p, vgg_p, style_x, fault=None):
    """Each attention's sampled ``G`` (1, Dk, Nk) and ``style_flat`` (1, Nk,
    Dv) of one network-space style image."""
    feats = encode(vgg_p, style_x)
    cache = []
    for pre, site, max_sample in SITES:
        g = _conv1x1(p, pre + "g", get_key(feats, site, fault))
        hh = _conv1x1(p, pre + "h", feats[site])
        b, _, h_g, w_g = g.size()
        g = g.view(b, -1, w_g * h_g)
        if w_g * h_g > max_sample:
            seed = SEED + 1 if fault == "other_permutation" and site == 2 else SEED
            index = torch.randperm(w_g * h_g, generator=torch.Generator().manual_seed(seed))
            index = index.to(style_x.device)[:max_sample]
            g = g[:, :, index]
            style_flat = hh.view(b, -1, w_g * h_g)[:, :, index].transpose(1, 2)
        else:
            style_flat = hh.view(b, -1, w_g * h_g).transpose(1, 2)
        cache.append((g, style_flat))
    return cache


def _adaattn(p, pre, content, content_key, g, style_flat, fault):
    fq = _conv1x1(p, pre + "f", content_key)
    b, _, h, w = fq.size()
    fq = fq.view(b, -1, w * h).permute(0, 2, 1)
    g, style_flat = g.expand(b, -1, -1), style_flat.expand(b, -1, -1)
    means, stds = [], []
    for i in range(0, h * w, BLOCK_Q):
        s = torch.softmax(torch.bmm(fq[:, i:i + BLOCK_Q], g), dim=-1)
        mean = torch.bmm(s, style_flat)
        means.append(mean)
        stds.append(torch.sqrt(torch.relu(torch.bmm(s, style_flat ** 2) - mean ** 2)))
    mean = torch.cat(means, 1).view(b, h, w, -1).permute(0, 3, 1, 2)
    std = torch.cat(stds, 1).view(b, h, w, -1).permute(0, 3, 1, 2)
    if fault == "no_std":
        return mean_variance_norm(content) + mean
    return std * mean_variance_norm(content) + mean


def forward(p, vgg_p, x, cache, fault=None):
    """Network-space NCHW content and a style's ``style_cache`` -> [0,
    1]-space pixels, unclamped."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    feats = encode(vgg_p, x)
    outs = [_adaattn(p, pre, feats[site], get_key(feats, site, fault), g, style_flat, fault)
            for (pre, site, _), (g, style_flat) in zip(SITES, cache)]
    t = outs[1] + F.interpolate(outs[2], scale_factor=2, mode="nearest")
    t = reflect_conv(t, p["transformer.merge_conv.weight"], p["transformer.merge_conv.bias"])
    cs = torch.relu(reflect_conv(t, p["decoder.decoder_layer_1.1.weight"],
                                 p["decoder.decoder_layer_1.1.bias"]))
    cs = F.interpolate(cs, scale_factor=2, mode="nearest")
    skip = torch.zeros_like(outs[0]) if fault == "no_skip" else outs[0]
    cs = torch.cat((cs, skip), dim=1)
    for i, (idx, _, _, up) in enumerate(LAYER_2):
        if up:
            cs = F.interpolate(cs, scale_factor=2, mode="nearest")
        cs = reflect_conv(cs, p[f"decoder.decoder_layer_2.{idx}.weight"],
                          p[f"decoder.decoder_layer_2.{idx}.bias"])
        if i != len(LAYER_2) - 1:
            cs = torch.relu(cs)
    return cs
