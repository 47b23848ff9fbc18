"""Counts of AdaAttN (arXiv:2108.03647) per content image, with everything
that depends on the style alone left out (its encoding, g(K_s), h(F_s)),
whether or not the program caches it.

As ``FlopCounterMode`` counts: 2 per multiply-add of each convolution and
matrix product; a site's attention of Nq queries over Nk style positions
2 * Nq * Nk * (Dqk + 2 * Dv) (the scores and both moments). The key
builder's instance norms, the softmax, interpolation and adds are not
counted."""

from counts.layers import conv_flops, vgg_flops

IN_FLOPS_PER_ELEMENT = 8  # as counts/stylenet.py: stats, normalize, rounded up

WIDTHS = (64, 128, 256, 512, 512)  # relu1_1 .. relu5_1
# (VGG level, grid divisor, most style positions kept) of the three sites
SITES = ((2, 4, 64 * 64), (3, 8, 256 * 256), (4, 16, 256 * 256))
STYLE_SIDE = 512  # the configuration's one cached 512 x 512 style
# the decoder's 3x3 convs: (C_in, C_out, grid divisor)
DECODER = [(512, 256, 8), (512, 256, 4), (256, 256, 4), (256, 256, 4), (256, 128, 4),
           (128, 128, 2), (128, 64, 2), (64, 64, 1), (64, 3, 1)]


def site_shapes(h: int, w: int, style_hw=(STYLE_SIDE, STYLE_SIDE)):
    """(Nq, Nk, Dqk, Dv) of each site for an h x w content image."""
    out = []
    for level, div, max_sample in SITES:
        nk = min((style_hw[0] // div) * (style_hw[1] // div), max_sample)
        out.append(((h // div) * (w // div), nk, sum(WIDTHS[:level + 1]), WIDTHS[level]))
    return out


def attention_flops(nq: int, nk: int, dqk: int, dv: int) -> float:
    return 2.0 * nq * nk * (dqk + 2 * dv)


def forward_flops(h: int, w: int, style_hw=(STYLE_SIDE, STYLE_SIDE)) -> float:
    """One content image at h x w: VGG19 to relu5_1, the queries, the three
    attentions, the merge conv and the decoder."""
    vgg = vgg_flops(h, w, "conv4_4") + conv_flops(h // 16, w // 16, 512, 512, 3)
    sites = site_shapes(h, w, style_hw)
    queries = sum(2.0 * nq * dqk * dqk for nq, _, dqk, _ in sites)
    attention = sum(attention_flops(*s) for s in sites)
    merge = conv_flops(h // 8, w // 8, 512, 512, 3)
    dec = sum(conv_flops(h // d, w // d, cin, cout, 3) for cin, cout, d in DECODER)
    return vgg + queries + attention + merge + dec


def attention_cost(n: int, h: int, w: int, itemsize: int, style_hw=(STYLE_SIDE, STYLE_SIDE)):
    """(operations, bytes) of the three moment attentions of one batch of n
    content images at h x w. Bytes: each image's queries, normalized
    content feature and output read or written once, the style's keys and
    values once per batch (every image shares them)."""
    flops = bytes_moved = 0.0
    for nq, nk, dqk, dv in site_shapes(h, w, style_hw):
        flops += n * attention_flops(nq, nk, dqk, dv)
        bytes_moved += (n * nq * (dqk + 2 * dv) + nk * (dqk + dv)) * itemsize
    return flops, bytes_moved


def in_fwd_cost(n: int, h: int, w: int, itemsize: int):
    """(operations, bytes) of the key builder's instance norms of one batch
    of n content images at h x w: at each site every VGG level up to it,
    downsampled to the site's grid, normalized once (3 + 4 + 5 = 12 IN
    forwards over 448, 960 and 1472 channels); x read once, y written once."""
    numel = n * sum(nq * dqk for nq, _, dqk, _ in site_shapes(h, w))
    return IN_FLOPS_PER_ELEMENT * numel, 2 * numel * itemsize
