"""AdaIN arbitrary style transfer (Huang & Belongie 2017, arXiv:1703.06868)
in plain torch, float32: VGG19 to relu4_1, adaptive instance norm to the
style's channel moments, and the decoder that mirrors VGG19 (reflect-padded
3x3 convolutions, ReLU after all but the last, nearest x2 upsampling), its
parameters named as the public decoder's ``nn.Sequential``."""

import torch
import torch.nn.functional as F

from reference import vgg
from reference.common import IN_EPS, reflect_conv

ENCODE_TAP = "relu4_1"
# (out channels, upsample before)
DECODER = [(256, False), (256, True), (256, False), (256, False), (128, False),
           (128, True), (64, False), (64, True), (3, False)]


def decoder_keys():
    """The ``nn.Sequential`` index of each decoder conv (Upsample,
    ReflectionPad2d, Conv2d, ReLU each take one)."""
    keys, idx = [], 0
    for i, (_, up) in enumerate(DECODER):
        idx += 1 if up else 0
        idx += 1  # the pad
        keys.append(str(idx))
        idx += 1
        idx += 1 if i != len(DECODER) - 1 else 0  # the ReLU
    return keys


def param_spec():
    """(name, shape, init, fan_in) of the decoder's convolutions: He-normal
    weights, which keep the activations' scale through the ReLUs as a
    trained decoder's do, so the image spans the u8 range; zero biases."""
    spec, cin = [], 512
    for key, (cout, _) in zip(decoder_keys(), DECODER):
        spec += [(f"{key}.weight", (cout, cin, 3, 3), "he_normal", cin * 9),
                 (f"{key}.bias", (cout,), "zero", 0)]
        cin = cout
    return spec


def style_moments(vgg_p, style_x, conv=F.conv2d):
    """The style's relu4_1 channel mean and standard deviation, (1, C, 1, 1)."""
    f = vgg.features(vgg_p, style_x, (ENCODE_TAP,), conv)[ENCODE_TAP]
    mean = f.mean(dim=(2, 3), keepdim=True)
    var = (f - mean).square().mean(dim=(2, 3), keepdim=True)
    return mean, torch.sqrt(var + IN_EPS)


def forward(dec_p, vgg_p, x, style_mean, style_std, conv=F.conv2d):
    """Content NCHW network space in, stylized network space out."""
    f = vgg.features(vgg_p, x, (ENCODE_TAP,), conv)[ENCODE_TAP]
    mean = f.mean(dim=(2, 3), keepdim=True)
    var = (f - mean).square().mean(dim=(2, 3), keepdim=True)
    h = (f - mean) * torch.rsqrt(var + IN_EPS) * style_std + style_mean
    for i, (key, (_, up)) in enumerate(zip(decoder_keys(), DECODER)):
        if up:
            h = F.interpolate(h, scale_factor=2, mode="nearest")
        h = reflect_conv(h, dec_p[key + ".weight"], dec_p[key + ".bias"], 1, conv)
        if i != len(DECODER) - 1:
            h = torch.relu(h)
    return h
