"""Multi-style: train ONE net on several styles, then select, blend and
save.

Conditional instance norm (``models/transformer.py``): per-style (S, C) IN
affine banks, shared convs. The train step draws a style per example;
inference bakes a selection or a convex blend back into a standard
single-style net (so the u8, int8, spatial and export paths are
unchanged). Synthetic data; the training CLI does this at scale with
``--style_image a.jpg b.jpg``, inference with ``--style_index`` /
``--style_blend``. Runs on the card unless ``--device cpu``.

    python -m fast_neural_style_transfer_tpu_torch.examples.multistyle [output_dir] [--device cpu]
"""

import os
import sys

import numpy as np
import torch

from fast_neural_style_transfer_tpu_torch.core import Precision, exact_f32, resolve_device
from fast_neural_style_transfer_tpu_torch.examples import parse_args
from fast_neural_style_transfer_tpu_torch.infer import Stylizer
from fast_neural_style_transfer_tpu_torch.losses import LossTaps, style_targets_from_features
from fast_neural_style_transfer_tpu_torch.models import (
    TransformerNet,
    bake_style,
    save_params_npz,
)
from fast_neural_style_transfer_tpu_torch.models.vgg_weights import make_vgg, resolve_params
from fast_neural_style_transfer_tpu_torch.train.schedule import LossWeightSchedule
from fast_neural_style_transfer_tpu_torch.train.state import create_train_state
from fast_neural_style_transfer_tpu_torch.train.step import make_train_step
from fast_neural_style_transfer_tpu_torch.utils import save_image

NUM_STYLES = 2


def main(out_dir: str = "multistyle_out", device=None) -> None:
    os.makedirs(out_dir, exist_ok=True)
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    prec = Precision.f32()
    exact_f32(dev, prec)
    taps = LossTaps(content_tap="relu4_2")
    vgg = make_vgg(resolve_params(None), dev)

    # 1. one net for S styles: (S, C) conditional-IN banks, shared convs
    torch.manual_seed(0)
    net = TransformerNet(num_styles=NUM_STYLES).to(dev, memory_format=torch.channels_last)

    # 2. per-layer (S, c, c) style-Gram banks, one row per style image
    per_style = []
    for _ in range(NUM_STYLES):
        s = torch.from_numpy(rng.normal(size=(1, 64, 64, 3)).astype(np.float32)).to(dev)
        with torch.no_grad():
            per_style.append(style_targets_from_features(
                vgg(s, taps.style_taps, precision=prec)))
    banks = [torch.stack(layer) for layer in zip(*per_style)]

    # 3. train: the step draws a style per example and conditions both the
    #    stylizer's instance norms and the loss targets with it
    state = create_train_state(net, lr=1e-3, total_steps=100)
    step = make_train_step(taps=taps, weight_schedule=LossWeightSchedule(),
                           precision=prec, lr=1e-3, total_steps=100,
                           num_styles=NUM_STYLES)
    batch = torch.from_numpy(rng.normal(size=(4, 64, 64, 3)).astype(np.float32)).to(dev)
    generator = torch.Generator(device=dev).manual_seed(1)
    for _ in range(3):
        metrics = step(state, vgg, batch, banks, generator)
        print(f"step {state.step}: loss {float(metrics['loss']):.4g}")

    # 4. serve: bake a style (or a blend) into a standard single-style net
    params = {k: v.detach().cpu() for k, v in state.net.state_dict().items()}
    image = rng.normal(size=(1, 96, 96, 3)).astype(np.float32)
    for name, choice in [("style0", 0), ("style1", 1), ("blend", [0.5, 0.5])]:
        out = Stylizer(bake_style(params, choice), device=dev)(image)
        save_image(out, os.path.join(out_dir, f"{name}.jpg"))

    # 5. the saved artifact keeps the banks; loaders require a selection
    final = os.path.join(out_dir, "multistyle_final.npz")
    save_params_npz(params, final)
    Stylizer.from_checkpoint(final, style=1, device=dev)(image)  # bakes on load
    print(f"wrote {sorted(os.listdir(out_dir))} to {out_dir}")


if __name__ == "__main__":
    main(*parse_args(sys.argv[1:], "multistyle_out", __doc__))
