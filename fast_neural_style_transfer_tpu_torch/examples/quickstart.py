"""Quickstart: the library API end to end on synthetic data.

Builds a stylizer, precomputes the style Gram targets, takes a few train
steps, stylizes an image at a non-square size, and exports ONNX and a
reference-layout ``.pth``. Runs on the card unless ``--device cpu``.

    python -m fast_neural_style_transfer_tpu_torch.examples.quickstart [output_dir] [--device cpu]
"""

import os
import sys

import numpy as np
import torch

from fast_neural_style_transfer_tpu_torch.core import Precision, exact_f32, resolve_device
from fast_neural_style_transfer_tpu_torch.examples import parse_args
from fast_neural_style_transfer_tpu_torch.export import export_onnx, save_torch_checkpoint
from fast_neural_style_transfer_tpu_torch.infer import Stylizer
from fast_neural_style_transfer_tpu_torch.losses import LossTaps, style_targets_from_features
from fast_neural_style_transfer_tpu_torch.models import TransformerNet
from fast_neural_style_transfer_tpu_torch.models.vgg_weights import make_vgg, resolve_params
from fast_neural_style_transfer_tpu_torch.train.schedule import LossWeightSchedule
from fast_neural_style_transfer_tpu_torch.train.state import create_train_state
from fast_neural_style_transfer_tpu_torch.train.step import make_train_step
from fast_neural_style_transfer_tpu_torch.utils import save_image


def main(out_dir: str = "quickstart_out", device=None) -> None:
    os.makedirs(out_dir, exist_ok=True)
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    prec = Precision.f32()
    exact_f32(dev, prec)
    taps = LossTaps(content_tap="relu4_2")

    # 1. networks: the stylizer + frozen VGG features (pretrained weights via
    #    FNST_VGG19_WEIGHTS / resolve_params(path); a seeded random VGG here)
    torch.manual_seed(0)
    net = TransformerNet().to(dev, memory_format=torch.channels_last)
    vgg = make_vgg(resolve_params(None), dev)

    # 2. one-time style targets from a style image (synthetic stand-in)
    style = torch.from_numpy(rng.normal(size=(1, 64, 64, 3)).astype(np.float32)).to(dev)
    with torch.no_grad():
        grams = [g.detach() for g in style_targets_from_features(
            vgg(style, taps.style_taps, precision=prec))]

    # 3. a few train steps (autograd, Adam, the non-finite guard)
    state = create_train_state(net, lr=1e-3, total_steps=100)
    step = make_train_step(taps=taps, weight_schedule=LossWeightSchedule(),
                           precision=prec, lr=1e-3, total_steps=100)
    batch = torch.from_numpy(rng.normal(size=(2, 64, 64, 3)).astype(np.float32)).to(dev)
    generator = torch.Generator(device=dev).manual_seed(1)
    for _ in range(3):
        metrics = step(state, vgg, batch, grams, generator)
        print(f"step {state.step}: loss {float(metrics['loss']):.4g}")

    # 4. arbitrary-resolution inference (bucketing handles the odd size)
    params = {k: v.detach().cpu() for k, v in state.net.state_dict().items()}
    stylizer = Stylizer(params, device=dev)
    image = rng.normal(size=(1, 100, 156, 3)).astype(np.float32)
    out = stylizer(image)
    save_image(out, os.path.join(out_dir, "stylized.jpg"))

    # 5. export: ONNX (dependency-free writer) + reference-layout .pth
    export_onnx(params, os.path.join(out_dir, "model.onnx"))
    save_torch_checkpoint(params, os.path.join(out_dir, "model.pth"))
    print(f"wrote {sorted(os.listdir(out_dir))} to {out_dir}")


if __name__ == "__main__":
    main(*parse_args(sys.argv[1:], "quickstart_out", __doc__))
