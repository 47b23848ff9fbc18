"""The reference stylizer: ``Stylizer.stylize_u8`` under test, the plain
reference of ``reference/stylenet.py`` to judge it, and the program's own
int8 path as the lower-precision control."""

import numpy as np
import torch

from harness import seeded
from reference import stylenet as ref
from reference.common import float32_math, pad_to_bucket, to_network, to_u8


def make_weights(seed: int, device) -> dict:
    return {"net": seeded.weights(ref.param_spec(), seeded.sub_seed(seed, 1), device)}


def serve_forward(config: dict, weights: dict, traffic: dict, device, variant: str):
    """-> the u8 batch forward the server runs: the program at the
    configuration's precision, or with "control" its int8 path."""
    from fast_neural_style_transfer_tpu_torch.infer.stylize import Stylizer

    precision = config["precision"] if variant == "program" else "int8"
    sty = Stylizer(weights["net"], precision=precision,
                   bucket_multiple=traffic["bucket_multiple"], device=device)
    return sty.stylize_u8


def reference_u8(weights: dict, images, multiple: int, device, block: int = 8):
    """The reference's uint8 output of each HWC image, padded to its bucket
    as the server pads, in float32, in blocks of same-bucket images."""
    out = [None] * len(images)
    groups = {}
    for i, img in enumerate(images):
        padded = pad_to_bucket(img, multiple)
        groups.setdefault(padded.shape, []).append((i, padded))
    with torch.no_grad(), float32_math():
        for members in groups.values():
            for at in range(0, len(members), block):
                chunk = members[at:at + block]
                x = torch.from_numpy(np.stack([p for _, p in chunk])).to(device)
                y = to_u8(ref.forward(weights["net"], to_network(x))).cpu().numpy()
                for (i, _), yi in zip(chunk, y):
                    h, w, _ = images[i].shape
                    out[i] = yi[:h, :w]
    return out
