"""Counts of AdaIN (Huang & Belongie 2017): VGG19 to relu4_1, AdaIN, the
mirrored decoder."""

from counts.layers import conv_flops, vgg_flops

ENCODE_CONV = "conv4_1"
# (C_in, C_out, spatial divisor) of the decoder's 3x3 convs
DECODER = [(512, 256, 8), (256, 256, 4), (256, 256, 4), (256, 256, 4), (256, 128, 4),
           (128, 128, 2), (128, 64, 2), (64, 64, 1), (64, 3, 1)]
IN_FLOPS_PER_ELEMENT = 8


def forward_flops(h: int, w: int) -> float:
    """One image's encoder and decoder at h x w (the AdaIN itself is a
    normalization, counted with the kernels)."""
    dec = sum(conv_flops(h // d, w // d, cin, cout, 3) for cin, cout, d in DECODER)
    return vgg_flops(h, w, ENCODE_CONV) + dec


def in_sites(n: int, h: int, w: int):
    """(N, C, H, W) of the one IN site (AdaIN at relu4_1)."""
    return [(n, 512, h // 8, w // 8)]


def in_fwd_cost(n: int, h: int, w: int, itemsize: int):
    numel = n * 512 * (h // 8) * (w // 8)
    return IN_FLOPS_PER_ELEMENT * numel, 2 * numel * itemsize
