"""The reference stylizer's training step in plain torch, float32: the
stylizer's forward with its dropout masks, the image clamped to [-3, 3],
VGG19 on the content (no gradient) and on the stylized image, the
perceptual losses of the reference (style: squared Gram differences over
c^2 at relu1_2, relu2_2, relu3_3 weighted 0.25, 0.3, 0.45; content: squared
differences at relu4_2 over c*h*w; total variation over b*c*h*w; weights
1000, 1, 10), and the update: global-norm clip at 1, weight decay 1e-5
added to the clipped gradient, Adam (0.9, 0.999, eps 1e-8) with the
cosine learning rate (1e-3 to 1e-7 over ``total_steps``)."""

import math

import numpy as np
import torch

from reference import stylenet, vgg
from reference.common import to_network

STYLE_TAPS = ("relu1_2", "relu2_2", "relu3_3")
STYLE_WEIGHTS = (0.25, 0.3, 0.45)
CONTENT_TAP = "relu4_2"
LOSS_WEIGHTS = (1000.0, 1.0, 10.0)  # content, style, TV
CLAMP = 3.0
BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
WEIGHT_DECAY = 1e-5
CLIP = 1.0
ETA_MIN = 1e-7


def gram(f):
    """(b, c, h, w) -> (b, c, c), unnormalized."""
    b, c, h, w = f.shape
    m = f.reshape(b, c, h * w)
    return torch.bmm(m, m.transpose(1, 2))


def style_grams(vgg_p, style_u8_hwc):
    """The style image's Gram targets, (c, c) each."""
    feats = vgg.features(vgg_p, to_network(style_u8_hwc[None]), STYLE_TAPS)
    return [gram(feats[t])[0] for t in STYLE_TAPS]


def loss(p, vgg_p, batch_u8, grams, keeps):
    """The weighted loss of one batch (uint8 NHWC) under the given masks."""
    x = to_network(batch_u8)
    out = torch.clamp(stylenet.forward(p, x, keeps), -CLAMP, CLAMP)
    with torch.no_grad():
        target = vgg.features(vgg_p, x, (CONTENT_TAP,))[CONTENT_TAP]
    feats = vgg.features(vgg_p, out, STYLE_TAPS + (CONTENT_TAP,))
    style = 0.0
    for t, g, w in zip(STYLE_TAPS, grams, STYLE_WEIGHTS):
        c = g.shape[-1]
        style = style + w * torch.sum(torch.square(gram(feats[t]) - g[None])) / (c * c)
    f = feats[CONTENT_TAP]
    b, c, h, w = f.shape
    content = torch.sum(torch.square(f - target)) / (c * h * w)
    tv = (torch.sum(torch.square(out[:, :, 1:] - out[:, :, :-1]))
          + torch.sum(torch.square(out[:, :, :, 1:] - out[:, :, :, :-1]))) / (
        out.shape[0] * out.shape[1] * out.shape[2] * out.shape[3])
    cw, sw, tw = LOSS_WEIGHTS
    return cw * content + sw * style + tw * tv


def cosine_lr(step: int, lr: float, total_steps: int) -> float:
    t = np.float32(min(step, total_steps))
    cos = np.float32(np.cos(np.float32(math.pi) * t / np.float32(total_steps)))
    return float(np.float32(ETA_MIN) + (np.float32(lr) - np.float32(ETA_MIN))
                 * (np.float32(1.0) + cos) / np.float32(2.0))


def train(params, vgg_p, batches_u8, style_u8, generator, *, lr: float, total_steps: int):
    """Run ``len(batches_u8)`` steps from ``params`` (not modified), the
    dropout masks drawn from ``generator``. -> (losses, first_grads,
    raw_first_grads, params after the steps): first_grads are what Adam
    got at step 1 (clipped, plus the weight decay), raw_first_grads the
    loss's own gradients."""
    names = list(params)
    p = {k: params[k].detach().clone().requires_grad_(True) for k in names}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v = {k: torch.zeros_like(t) for k, t in p.items()}
    grams = [g.detach() for g in style_grams(vgg_p, style_u8)]
    losses, first, raw_first = [], None, None
    for step, batch in enumerate(batches_u8):
        keeps = stylenet.dropout_masks(batch.shape[0], generator, batch.device)
        total = loss(p, vgg_p, batch, grams, keeps)
        grads = torch.autograd.grad(total, [p[k] for k in names])
        losses.append(float(total.detach()))
        norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
        scale = 1.0 if float(norm) < CLIP else CLIP / norm
        rate = cosine_lr(step, lr, total_steps)
        with torch.no_grad():
            got = {}
            for k, g in zip(names, grads):
                g = g * scale + WEIGHT_DECAY * p[k]
                got[k] = g
                m[k] = BETAS[0] * m[k] + (1 - BETAS[0]) * g
                v[k] = BETAS[1] * v[k] + (1 - BETAS[1]) * g * g
                bc1 = 1 - BETAS[0] ** (step + 1)
                bc2 = 1 - BETAS[1] ** (step + 1)
                denom = v[k].sqrt() / math.sqrt(bc2) + ADAM_EPS
                p[k] -= (rate / bc1) * m[k] / denom
        if first is None:
            first = got
            raw_first = dict(zip(names, [g.detach() for g in grads]))
    return losses, first, raw_first, {k: t.detach() for k, t in p.items()}
