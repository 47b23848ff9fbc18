"""StyTr² (Deng et al., CVPR 2022, arXiv:2105.14576) in plain float32 torch:
the tests' reference for ``models/stytr2.py`` and ``infer/stytr2.py``.

It imports nothing of the port and no JAX, and turns TF32 off for both
convolutions and matmuls. Parameters are a flat dict under the port's
state_dict names, which are the official checkpoints' with a part prefix
(``embedding.``, ``transformer.``, ``decoder.``). Images are NCHW in [0, 1].

Following the official code (``models/StyTR.py``, ``models/transformer.py``,
``forward_post``): patch embedding ``Conv2d(3, d, 8, stride 8)``; CAPE =
bilinear(Conv1x1(AdaptiveAvgPool2d(18)(E_c))), added to the content's
queries and keys; post-norm encoders ``x = LN(x + MHA(x + pos, x + pos,
x)); x = LN(x + W2 relu(W1 x))``; decoder layers whose two attentions both
take queries ``t + P`` and keys and values the encoded style; a final
LayerNorm; the AdaIN decoder (reflect-padded 3x3 convs, nearest x2 before
the 2nd, 6th and 8th); attention softmax(q k^T / sqrt(d / heads)) v.

Departures from the official code:
- CAPE is interpolated to the content's token grid; the official code
  interpolates to the style's, the same grid when both are 512².
- The decoder's tokens are reshaped to the content's (h, w) grid; the
  official code assumes a square one (``H = sqrt(N)``).
- No dropout (inference) and no masks (the official code passes none).
"""

import torch
import torch.nn.functional as F

PATCH = 8
CAPE_POOL = 18
LN_EPS = 1e-5
# (out channels, nearest x2 upsample before) of the AdaIN decoder's convs
CNN = [(256, False), (256, True), (256, False), (256, False), (128, False),
       (128, True), (64, False), (64, True), (3, False)]


def _layers(p, prefix: str) -> int:
    return len({k[len(prefix):].split(".")[0] for k in p if k.startswith(prefix)})


def layer_norm(x, w, b):
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + LN_EPS) * w + b


def linear(x, w, b):
    return x @ w.t() + b


def attention(p, prefix, q_in, k_in, v_in, nhead):
    """nn.MultiheadAttention's forward on (B, N, d) inputs, no dropout."""
    w, b = p[prefix + "in_proj_weight"], p[prefix + "in_proj_bias"]
    d = w.shape[1]
    q = linear(q_in, w[:d], b[:d])
    k = linear(k_in, w[d:2 * d], b[d:2 * d])
    v = linear(v_in, w[2 * d:], b[2 * d:])

    def heads(t):
        return t.reshape(t.shape[0], t.shape[1], nhead, d // nhead).transpose(1, 2)

    q, k, v = heads(q), heads(k), heads(v)
    scores = q @ k.transpose(-1, -2) / (d // nhead) ** 0.5
    o = torch.softmax(scores, dim=-1) @ v
    o = o.transpose(1, 2).reshape(q_in.shape[0], q_in.shape[1], d)
    return linear(o, p[prefix + "out_proj.weight"], p[prefix + "out_proj.bias"])


def ffn(p, prefix, x):
    h = torch.relu(linear(x, p[prefix + "linear1.weight"], p[prefix + "linear1.bias"]))
    return linear(h, p[prefix + "linear2.weight"], p[prefix + "linear2.bias"])


def norm(p, prefix, x):
    return layer_norm(x, p[prefix + "weight"], p[prefix + "bias"])


def embed(p, x):
    """(B, 3, H, W) -> (B, d, H/8, W/8)."""
    return F.conv2d(x, p["embedding.proj.weight"], p["embedding.proj.bias"], stride=PATCH)


def tokens(e):
    return e.flatten(2).transpose(1, 2)


def cape(p, e):
    pooled = F.adaptive_avg_pool2d(e, CAPE_POOL)
    pos = F.conv2d(pooled, p["transformer.new_ps.weight"], p["transformer.new_ps.bias"])
    return tokens(F.interpolate(pos, size=e.shape[-2:], mode="bilinear", align_corners=False))


def encoder(p, name, x, pos, nhead):
    for i in range(_layers(p, f"transformer.{name}.layers.")):
        pre = f"transformer.{name}.layers.{i}."
        qk = x if pos is None else x + pos
        x = norm(p, pre + "norm1.", x + attention(p, pre + "self_attn.", qk, qk, x, nhead))
        x = norm(p, pre + "norm2.", x + ffn(p, pre, x))
    return x


def decoder(p, t, m, pos, nhead):
    for i in range(_layers(p, "transformer.decoder.layers.")):
        pre = f"transformer.decoder.layers.{i}."
        t = norm(p, pre + "norm1.", t + attention(p, pre + "self_attn.", t + pos, m, m, nhead))
        t = norm(p, pre + "norm2.",
                 t + attention(p, pre + "multihead_attn.", t + pos, m, m, nhead))
        t = norm(p, pre + "norm3.", t + ffn(p, pre, t))
    return norm(p, "transformer.decoder.norm.", t)


def transform(p, content, style, nhead):
    """The transformer's output tokens (B, N, d) for [0, 1] NCHW content and
    style (sides multiples of 8; a style batch of 1 serves every content)."""
    with _float32():
        e_c = embed(p, content)
        pos = cape(p, e_c)
        m = encoder(p, "encoder_s", tokens(embed(p, style)), None, nhead)
        m = m.expand(content.shape[0], -1, -1)
        x = encoder(p, "encoder_c", tokens(e_c), pos, nhead)
        return decoder(p, x, m, pos, nhead)


def cnn(p, t, h, w):
    """Tokens (B, h * w, 512) -> [0, 1]-space pixels (B, 3, 8h, 8w), unclamped."""
    with _float32():
        x = t.transpose(1, 2).reshape(t.shape[0], -1, h, w)
        idx = 0
        for i, (_, up) in enumerate(CNN):
            if up:
                x = F.interpolate(x, scale_factor=2, mode="nearest")
                idx += 1
            idx += 1  # ReflectionPad2d
            x = F.conv2d(F.pad(x, (1, 1, 1, 1), mode="reflect"), p[f"decoder.{idx}.weight"],
                         p[f"decoder.{idx}.bias"])
            idx += 1
            if i != len(CNN) - 1:
                x = torch.relu(x)
                idx += 1
        return x


def forward(p, content, style, nhead):
    """[0, 1] NCHW content and style -> [0, 1]-space pixels, unclamped."""
    t = transform(p, content, style, nhead)
    return cnn(p, t, content.shape[2] // PATCH, content.shape[3] // PATCH)


class _float32:
    def __enter__(self):
        self.old = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = self.old
        return False
