"""AdaAttN with a cached style: ``AttentionalStylizer.stylize_u8`` under
test, built as ``fnst-serve --adaattn`` builds it; the plain reference of
``reference/adaattn.py`` to judge it; and as the lower-precision control
that reference with every weight and every tensor it computes stored in
float8 e4m3 (``systems/stytr2.py::StoredIn``), the card's precision below
the configuration's bf16."""

import contextlib

import numpy as np
import torch

from harness import seeded
from harness.systems.stytr2 import LOWER, StoredIn, _to_u8, rounded
from reference import adaattn as ref
from reference import vgg as ref_vgg
from reference.common import float32_math, pad_to_bucket, to_network

STYLE_SIDE = 512
# the official init_net's N(0, 0.02) for the attentions' 1x1 convs and the
# merge conv, from the spec's He-normal draw
INIT_STD = 0.02
# each site's f and g scaled from N(0, 0.02), so that the logits spread
# with a standard deviation of 3-6 (measured on the seeded weights:
# configs/adaattn.json); 1.0 leaves a site at the official init
QK_SCALE = {"adaattn_3.": 1.0, "transformer.attn_adain_4_1.": 0.65,
            "transformer.attn_adain_5_1.": 0.47}
# the decoder's last conv, so that the [0, 1] output spans the u8 range:
# He-normal weights scaled, bias mid-range
LAST_CONV_SCALE = 0.2
LAST_CONV_BIAS = 0.5


def make_weights(seed: int, device) -> dict:
    w = seeded.weights(ref.param_spec(), seeded.sub_seed(seed, 1), device)
    for name, shape, _, fan_in in ref.param_spec():
        if name.endswith(".weight") and not name.startswith("decoder."):
            scale = INIT_STD / float(np.sqrt(2.0 / fan_in))
            pre, conv = name[:-len("x.weight")], name[-len("x.weight")]
            if conv in "fg" and pre in QK_SCALE:
                scale *= QK_SCALE[pre]
            w[name] = w[name] * scale
    wk, bk = ref.last_conv()
    w[wk] = w[wk] * LAST_CONV_SCALE
    w[bk] = torch.full_like(w[bk], LAST_CONV_BIAS)
    return {"model": w,
            "vgg": seeded.weights(ref_vgg.param_spec(), seeded.sub_seed(seed, 2), device),
            "style": seeded.images(1, STYLE_SIDE, STYLE_SIDE, seeded.sub_seed(seed, 3), device)[0]}


def _network(batch_u8: np.ndarray, device) -> torch.Tensor:
    return to_network(torch.from_numpy(np.ascontiguousarray(batch_u8)).to(device))


def reference_forward(weights: dict, device, fault=None, stored=None):
    """u8 NHWC batch (host) -> u8 NHWC (host), the whole of AdaAttN computed
    by the reference (with ``fault``), one image at a time; with ``stored``
    a dtype, every weight and every tensor it computes stored in that dtype
    (``StoredIn``)."""
    mode = contextlib.nullcontext if stored is None else lambda: StoredIn(stored)
    p, vp = weights["model"], weights["vgg"]
    with torch.no_grad(), float32_math():
        if stored is not None:
            p = {k: rounded(v, stored) for k, v in p.items()}
            vp = {k: rounded(v, stored) for k, v in vp.items()}
        with mode():
            cache = ref.style_cache(p, vp, _network(weights["style"][None], device), fault)

    def forward(batch_u8: np.ndarray) -> np.ndarray:
        outs = []
        for i in range(len(batch_u8)):
            with torch.no_grad(), float32_math():
                with mode():
                    y = ref.forward(p, vp, _network(batch_u8[i:i + 1], device), cache, fault)
                outs.append(_to_u8(y))
        return np.concatenate(outs)
    return forward


def serve_forward(config: dict, weights: dict, traffic: dict, device, variant: str):
    """-> the u8 batch forward the server runs: the program at the
    configuration's precision with the style cached, or with "control" the
    reference stored in float8."""
    if variant == "control":
        return reference_forward(weights, device, stored=LOWER)
    from fast_neural_style_transfer_tpu_torch.infer.adaattn import AttentionalStylizer

    sty = AttentionalStylizer(weights["model"], weights["vgg"], precision=config["precision"],
                              bucket_multiple=traffic["bucket_multiple"], device=device)
    sty.set_style_u8(weights["style"])
    return sty.stylize_u8


def reference_u8(weights: dict, images, multiple: int, device, fault=None):
    fwd = reference_forward(weights, device, fault=fault)
    out = []
    for img in images:
        h, w, _ = img.shape
        out.append(fwd(pad_to_bucket(img, multiple)[None])[0][:h, :w])
    return out
