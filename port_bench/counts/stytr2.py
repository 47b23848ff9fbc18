"""Counts of StyTr² (arXiv:2105.14576) per content image, with everything
that depends on the style alone left out (its embedding, ``encoder_s``, and
the decoder attentions' keys and values of the style), whether or not the
program caches it: caching more of the style cannot move the yardstick.

As ``FlopCounterMode`` counts: 2 per multiply-add of each convolution and
matrix product; an attention of Nq queries over Nk keys 4 * Nq * Nk * d (the
scores and the weighted sum). LayerNorms, pooling, interpolation, softmax
and adds are not counted."""

from counts.adain import DECODER
from counts.layers import conv_flops

D, FFN, LAYERS, PATCH, CAPE_POOL = 512, 2048, 3, 8, 18


def tokens(h: int, w: int) -> int:
    return (h // PATCH) * (w // PATCH)


STYLE_TOKENS = tokens(512, 512)  # the configuration's one cached 512 x 512 style


def attention_flops(nq: int, nk: int, d: int = D) -> float:
    return 4.0 * nq * nk * d


def transformer_flops(h: int, w: int, style_tokens: int = STYLE_TOKENS, d: int = D,
                      ffn: int = FFN, layers: int = LAYERS) -> float:
    """Patch embedding, CAPE's 1x1 conv, ``encoder_c`` and the decoder of
    one content image attending to ``style_tokens`` style tokens."""
    n = tokens(h, w)
    ns = style_tokens
    embed = conv_flops(h // PATCH, w // PATCH, 3, d, PATCH)
    cape = conv_flops(CAPE_POOL, CAPE_POOL, d, d, 1)
    mlp = 2.0 * n * d * ffn * 2
    enc = 2.0 * n * d * 4 * d + mlp + attention_flops(n, n, d)  # q, k, v, out; FFN
    dec = 2 * (2.0 * n * d * 2 * d + attention_flops(n, ns, d)) + mlp  # q, out twice; FFN
    return embed + cape + layers * (enc + dec)


def forward_flops(h: int, w: int, **widths) -> float:
    """One content image's transformer and AdaIN decoder at h x w, the
    style's work left out."""
    cnn = sum(conv_flops(h // dv, w // dv, cin, cout, 3) for cin, cout, dv in DECODER)
    return transformer_flops(h, w, **widths) + cnn


def attention_cost(n: int, h: int, w: int, itemsize: int, style_tokens: int = STYLE_TOKENS,
                   layers: int = LAYERS, d: int = D):
    """(operations, bytes) of the attentions of one batch of n content
    images at h x w: ``encoder_c``'s self-attentions and the decoder's two
    cross-attentions a layer. Bytes: each query and output read or written
    once, a self-attention's keys and values once per image, the style's
    keys and values once per batch (every image shares them)."""
    nq, ns = tokens(h, w), style_tokens
    flops = layers * n * (attention_flops(nq, nq, d) + 2 * attention_flops(nq, ns, d))
    self_bytes = 4 * n * nq * d * itemsize
    cross_bytes = (2 * n * nq * d + 2 * ns * d) * itemsize
    return flops, layers * (self_bytes + 2 * cross_bytes)
