"""AdaIN with a cached style: ``ArbitraryStylizer.stylize_u8`` under test,
the plain reference of ``reference/adain.py`` to judge it, and that
reference computed with int8 convolutions as the lower-precision control
(the program has no precision below bf16 for AdaIN)."""

import numpy as np
import torch

from harness import seeded
from reference import adain as ref
from reference import vgg as ref_vgg
from reference.common import float32_math, int8_conv2d, pad_to_bucket, to_network, to_u8

STYLE_SIDE = 512


def make_weights(seed: int, device) -> dict:
    return {"decoder": seeded.weights(ref.param_spec(), seeded.sub_seed(seed, 1), device),
            "vgg": seeded.weights(ref_vgg.param_spec(), seeded.sub_seed(seed, 2), device),
            "style": seeded.images(1, STYLE_SIDE, STYLE_SIDE, seeded.sub_seed(seed, 3), device)[0]}


def _reference_forward(weights: dict, device, conv):
    """u8 NHWC batch (host) -> u8 NHWC (host), the whole of AdaIN computed
    by the reference with ``conv``."""
    with torch.no_grad(), float32_math():
        style = to_network(torch.from_numpy(weights["style"][None]).to(device))
        mean, std = ref.style_moments(weights["vgg"], style, conv)

    def forward(batch_u8: np.ndarray) -> np.ndarray:
        with torch.no_grad(), float32_math():
            x = to_network(torch.from_numpy(np.ascontiguousarray(batch_u8)).to(device))
            return to_u8(ref.forward(weights["decoder"], weights["vgg"], x, mean, std,
                                     conv)).cpu().numpy()
    return forward


def serve_forward(config: dict, weights: dict, traffic: dict, device, variant: str):
    """-> the u8 batch forward the server runs: the program at the
    configuration's precision with the style cached, or with "control" the
    reference in int8."""
    if variant == "control":
        return _reference_forward(weights, device, int8_conv2d)
    from fast_neural_style_transfer_tpu_torch.infer.adain import ArbitraryStylizer

    sty = ArbitraryStylizer(weights["decoder"], weights["vgg"], precision=config["precision"],
                            bucket_multiple=traffic["bucket_multiple"], device=device)
    sty.set_style_u8(weights["style"])
    return sty.stylize_u8


def reference_u8(weights: dict, images, multiple: int, device, block: int = 8):
    fwd = _reference_forward(weights, device, torch.nn.functional.conv2d)
    out = [None] * len(images)
    groups = {}
    for i, img in enumerate(images):
        padded = pad_to_bucket(img, multiple)
        groups.setdefault(padded.shape, []).append((i, padded))
    for members in groups.values():
        for at in range(0, len(members), block):
            chunk = members[at:at + block]
            y = fwd(np.stack([p for _, p in chunk]))
            for (i, _), yi in zip(chunk, y):
                h, w, _ = images[i].shape
                out[i] = yi[:h, :w]
    return out
