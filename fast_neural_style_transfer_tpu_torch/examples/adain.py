"""AdaIN arbitrary-style transfer through the library API.

One decoder (``models/adain.py``), ANY style image at inference: no
training run per style. Trains a few steps on synthetic data, then
stylizes with a style never seen in training, sweeps the alpha strength,
interpolates two styles, serves a cached style, keeps the content's
colours, and paints two regions with two styles. The AdaIN CLI
(``cli/adain.py``) does this at scale. Runs on the card unless
``--device cpu``.

    python -m fast_neural_style_transfer_tpu_torch.examples.adain [output_dir] [--device cpu]
"""

import os
import sys

import numpy as np
import torch

from fast_neural_style_transfer_tpu_torch.core import resolve_device
from fast_neural_style_transfer_tpu_torch.examples import parse_args
from fast_neural_style_transfer_tpu_torch.infer.adain import ArbitraryStylizer
from fast_neural_style_transfer_tpu_torch.models.adain import (
    make_decoder,
    save_decoder_npz,
    stylize_arbitrary,
)
from fast_neural_style_transfer_tpu_torch.models.vgg_weights import make_vgg, resolve_params
from fast_neural_style_transfer_tpu_torch.train.adain import (
    create_adain_train_state,
    make_adain_train_step,
)
from fast_neural_style_transfer_tpu_torch.utils import (
    luminance_transfer,
    match_color,
    normalize_image,
    save_image,
)


def main(out_dir: str = "adain_out", device=None) -> None:
    os.makedirs(out_dir, exist_ok=True)
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    vgg_params = resolve_params(None)
    vgg = make_vgg(vgg_params, dev)

    # 1. train the decoder: content and style batches stream independently;
    #    the step takes uint8 batches (the pipeline's transport dtype)
    torch.manual_seed(0)
    state = create_adain_train_state(make_decoder(None, dev), lr=1e-4)
    step = make_adain_train_step(lr=1e-4)
    content = torch.from_numpy(rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)).to(dev)
    style = torch.from_numpy(rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)).to(dev)
    for _ in range(3):
        metrics = step(state, vgg, content, style)
        print(f"step {state.step}: loss {float(metrics['loss']):.4g}")
    decoder = state.decoder.eval()

    def net_space(shape):
        """A seeded uint8 image, ImageNet-normalized, on the device."""
        u8 = rng.integers(0, 256, shape).astype(np.uint8)
        return torch.from_numpy(normalize_image(u8)).to(dev)

    def save(t, name):
        save_image(t.float().cpu().numpy(), os.path.join(out_dir, name))

    # 2. stylize with a NEVER-SEEN style image (that is the whole point)
    c_img = net_space((1, 96, 96, 3))
    s_new = net_space((1, 80, 80, 3))
    with torch.no_grad():
        save(stylize_arbitrary(decoder, vgg, c_img, s_new), "arbitrary.jpg")

        # 3. alpha sweeps style strength (0 reconstructs the content)
        for alpha in (0.0, 0.5, 1.0):
            save(stylize_arbitrary(decoder, vgg, c_img, s_new, alpha=alpha),
                 f"alpha{alpha:.1f}.jpg")

        # 4. interpolate two styles with convex weights (paper eq. 15)
        s_other = net_space((1, 64, 64, 3))
        save(stylize_arbitrary(decoder, vgg, c_img, [s_new, s_other],
                               style_weights=[0.7, 0.3]), "interpolated.jpg")

    # 5. serving: cache the style once (ArbitraryStylizer), then stream
    #    uint8 batches; alpha is an argument of each call
    params = {k: v.detach().cpu() for k, v in decoder.state_dict().items()}
    styler = ArbitraryStylizer(params, vgg_params, bucket_multiple=8, device=dev)
    styler.set_style_u8(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8))
    frames = rng.integers(0, 256, (4, 96, 96, 3), dtype=np.uint8)
    for a in (0.4, 1.0):
        out_u8 = styler.stylize_u8(frames, alpha=a)
        save_image(out_u8[0].astype(np.float32) / 255.0,
                   os.path.join(out_dir, f"served_a{a:.1f}.jpg"),
                   denormalize=False)  # stylize_u8 already returns pixels

    with torch.no_grad():
        # 6. colour control (paper §7.2): 'match' recolours the style before
        #    encoding; luminance transfer swaps the chrominance after
        save(stylize_arbitrary(decoder, vgg, c_img, match_color(s_new, c_img)),
             "color_matched.jpg")
        out = stylize_arbitrary(decoder, vgg, c_img, s_new)
        save(luminance_transfer(out, c_img), "color_luma.jpg")

        # 7. spatial style control (paper §7.3): per-pixel masks paint each
        #    content region with its own style
        masks = np.zeros((2, 96, 96), np.float32)
        masks[0, :, :48] = 1.0  # left half: s_new
        masks[1, :, 48:] = 1.0  # right half: s_other
        save(stylize_arbitrary(decoder, vgg, c_img, [s_new, s_other],
                               style_masks=masks), "masked_styles.jpg")

    save_decoder_npz(params, os.path.join(out_dir, "adain_decoder.npz"))
    print(f"wrote {sorted(os.listdir(out_dir))} to {out_dir}")


if __name__ == "__main__":
    main(*parse_args(sys.argv[1:], "adain_out", __doc__))
