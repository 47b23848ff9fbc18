"""StyTr² (Deng et al., CVPR 2022, arXiv:2105.14576) in plain torch,
float32: the benchmark's copy of the reference (the repository's tests hold
it against their own, ``tests/plain_stytr2.py``).

Patch embedding ``Conv2d(3, 512, 8, stride 8)`` on the [0, 1] image; CAPE =
bilinear(Conv1x1(AdaptiveAvgPool2d(18)(E_c))) to the content's token grid,
added to the content's queries and keys; ``encoder_c`` and ``encoder_s``, 3
post-norm layers each, ``x = LN(x + MHA(x + pos, x + pos, x)); x = LN(x +
W2 relu(W1 x))``; 3 decoder layers whose two attentions both take queries
``t + P`` and keys and values the encoded style m; a final LayerNorm; the
AdaIN decoder (``reference/adain.py``'s layout), whose output is [0, 1]
pixels, clamped. Attention is softmax(q k^T / 8) v over 8 heads of 64.
Parameters carry the port's state_dict names: the official checkpoints'
keys under ``embedding.``, ``transformer.`` and ``decoder.``.

Departures from the official code: CAPE is interpolated to the content's
grid (the official code takes the style's, the same at 512² both); the
tokens are reshaped to the content's (h, w) grid, not a square one; no
dropout and no masks.

``fault`` plants one of the faults the cell's limit must catch:
"no_cape" (P left out), "no_final_norm" (the decoder's last LayerNorm left
out), "self_first" (each decoder layer's first attention reads the content
stream as keys and values, DETR's self-attention)."""

import torch
import torch.nn.functional as F

from reference import adain
from reference.common import reflect_conv

D, HEADS, FFN, LAYERS = 512, 8, 2048, 3
PATCH, CAPE_POOL, LN_EPS = 8, 18, 1e-5
FAULTS = ("no_cape", "no_final_norm", "self_first")


def _mha_spec(pre: str, d: int):
    """nn.MultiheadAttention's parameters: Xavier-uniform matrices (as the
    official ``_reset_parameters``), zero biases. A "uniform" draw with
    fan_in (fan_in + fan_out) / 6 is Xavier-uniform's U(-a, a)."""
    return [(pre + "in_proj_weight", (3 * d, d), "uniform", (3 * d + d) / 6),
            (pre + "in_proj_bias", (3 * d,), "zero", 0),
            (pre + "out_proj.weight", (d, d), "uniform", (d + d) / 6),
            (pre + "out_proj.bias", (d,), "zero", 0)]


def _layer_spec(pre: str, attns, norms: int, d: int, ffn: int):
    spec = [s for a in attns for s in _mha_spec(f"{pre}{a}.", d)]
    spec += [(pre + "linear1.weight", (ffn, d), "uniform", (ffn + d) / 6),
             (pre + "linear1.bias", (ffn,), "uniform", d),
             (pre + "linear2.weight", (d, ffn), "uniform", (d + ffn) / 6),
             (pre + "linear2.bias", (d,), "uniform", ffn)]
    for i in range(1, norms + 1):
        spec += [(f"{pre}norm{i}.weight", (d,), "gamma", 0),
                 (f"{pre}norm{i}.bias", (d,), "beta", 0)]
    return spec


def param_spec(d: int = D, ffn: int = FFN, layers: int = LAYERS):
    """(name, shape, init, fan_in) of every parameter. The transformer's
    matrices Xavier-uniform, linear biases PyTorch's default; the patch
    embedding's and CAPE's 1x1 conv's weights He-normal, their biases
    PyTorch's default (with PyTorch's default weights the positional
    encoding is a tenth of the normalized token stream, and leaving it out
    moves the output less than bf16's rounding does); LayerNorm affines off
    the identity, weight U(0.5, 1.5), bias U(-0.5, 0.5) (with 1 and 0 the
    decoder's final LayerNorm repeats its last layer's, a no-op); the AdaIN
    decoder ``reference/adain.py``'s (He-normal, zero biases)."""
    spec = [("embedding.proj.weight", (d, 3, PATCH, PATCH), "he_normal", 3 * PATCH * PATCH),
            ("embedding.proj.bias", (d,), "uniform", 3 * PATCH * PATCH)]
    for enc in ("encoder_c", "encoder_s"):
        for i in range(layers):
            spec += _layer_spec(f"transformer.{enc}.layers.{i}.", ("self_attn",), 2, d, ffn)
    for i in range(layers):
        spec += _layer_spec(f"transformer.decoder.layers.{i}.", ("self_attn", "multihead_attn"),
                            3, d, ffn)
    spec += [("transformer.decoder.norm.weight", (d,), "gamma", 0),
             ("transformer.decoder.norm.bias", (d,), "beta", 0),
             ("transformer.new_ps.weight", (d, d, 1, 1), "he_normal", d),
             ("transformer.new_ps.bias", (d,), "uniform", d)]
    return spec + [("decoder." + n, shape, init, fan) for n, shape, init, fan in adain.param_spec()]


def last_conv():
    """The AdaIN decoder's last conv's parameter names."""
    key = "decoder." + adain.decoder_keys()[-1]
    return key + ".weight", key + ".bias"


def _layer_norm(x, w, b):
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + LN_EPS) * w + b


def _attention(p, pre, q_in, k_in, v_in):
    w, b = p[pre + "in_proj_weight"], p[pre + "in_proj_bias"]
    d = w.shape[1]
    q, k, v = (F.linear(t, w[i * d:(i + 1) * d], b[i * d:(i + 1) * d])
               for i, t in enumerate((q_in, k_in, v_in)))

    def heads(t):
        return t.reshape(t.shape[0], t.shape[1], HEADS, d // HEADS).transpose(1, 2)

    q, k, v = heads(q), heads(k), heads(v)
    o = torch.softmax(q @ k.transpose(-1, -2) / (d // HEADS) ** 0.5, dim=-1) @ v
    o = o.transpose(1, 2).reshape(q_in.shape[0], q_in.shape[1], d)
    return F.linear(o, p[pre + "out_proj.weight"], p[pre + "out_proj.bias"])


def _norm(p, pre, x):
    return _layer_norm(x, p[pre + "weight"], p[pre + "bias"])


def _ffn(p, pre, x):
    h = torch.relu(F.linear(x, p[pre + "linear1.weight"], p[pre + "linear1.bias"]))
    return F.linear(h, p[pre + "linear2.weight"], p[pre + "linear2.bias"])


def _tokens(e):
    return e.flatten(2).transpose(1, 2)


def _encoder(p, name, x, pos, layers):
    for i in range(layers):
        pre = f"transformer.{name}.layers.{i}."
        qk = x if pos is None else x + pos
        x = _norm(p, pre + "norm1.", x + _attention(p, pre + "self_attn.", qk, qk, x))
        x = _norm(p, pre + "norm2.", x + _ffn(p, pre, x))
    return x


def style_memory(p, style, layers: int = LAYERS):
    """The encoded style (1, N_s, d) of a [0, 1] NCHW style image."""
    e = F.conv2d(style, p["embedding.proj.weight"], p["embedding.proj.bias"], stride=PATCH)
    return _encoder(p, "encoder_s", _tokens(e), None, layers)


def forward(p, x, memory, fault=None, layers: int = LAYERS):
    """[0, 1] NCHW content and the encoded style -> [0, 1]-space pixels,
    unclamped."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    e = F.conv2d(x, p["embedding.proj.weight"], p["embedding.proj.bias"], stride=PATCH)
    b, d, h, w = e.shape
    pooled = F.adaptive_avg_pool2d(e, CAPE_POOL)
    pos = F.conv2d(pooled, p["transformer.new_ps.weight"], p["transformer.new_ps.bias"])
    pos = _tokens(F.interpolate(pos, size=(h, w), mode="bilinear", align_corners=False))
    if fault == "no_cape":
        pos = torch.zeros_like(pos)
    t = _encoder(p, "encoder_c", _tokens(e), pos, layers)
    m = memory.expand(b, -1, -1)
    for i in range(layers):
        pre = f"transformer.decoder.layers.{i}."
        kv, v = (t + pos, t) if fault == "self_first" else (m, m)
        t = _norm(p, pre + "norm1.", t + _attention(p, pre + "self_attn.", t + pos, kv, v))
        t = _norm(p, pre + "norm2.", t + _attention(p, pre + "multihead_attn.", t + pos, m, m))
        t = _norm(p, pre + "norm3.", t + _ffn(p, pre, t))
    if fault != "no_final_norm":
        t = _norm(p, "transformer.decoder.norm.", t)
    y = t.transpose(1, 2).reshape(b, d, h, w)
    for i, (key, (_, up)) in enumerate(zip(adain.decoder_keys(), adain.DECODER)):
        if up:
            y = F.interpolate(y, scale_factor=2, mode="nearest")
        y = reflect_conv(y, p[f"decoder.{key}.weight"], p[f"decoder.{key}.bias"])
        if i != len(adain.DECODER) - 1:
            y = torch.relu(y)
    return y
