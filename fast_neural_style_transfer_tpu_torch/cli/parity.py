"""fnst-parity: SSIM of the port's stylizer against the reference's own net
on the same ``.pth`` (the JAX package's ``cli/parity.py``).

Loads the checkpoint into BOTH the reference repository's
``StyleTransferNet`` (``<reference_repo>/models/model.py``, run on the CPU
in float32 as the oracle) and the port's ``Stylizer`` (on the card unless
``--device cpu``: the IN forward kernel at its 14 sites), runs the same
content image through both and prints one JSON line with the SSIM; exit
code 0 when it reaches the 0.98 threshold, 1 when not.

Input modes:
- ``reference-exact`` (default): raw [0, 1] input with no normalization,
  as the reference's inference script feeds it, and its ImageNet
  de-normalize + clamp on the output;
- ``canonical``: ImageNet-normalized input on both sides (what the model
  was trained with; the port's own inference path).

``--reference_sample`` also scores the port's output against a committed
reference output file; ``--output_dir`` saves both outputs
(``parity_ours.jpg``, ``parity_reference.jpg``).

    python -m fast_neural_style_transfer_tpu_torch.cli.parity \\
        --reference_pth ckpt.pth --content photo.jpg \\
        --reference_repo <reference checkout> [--size 256 256] \\
        [--mode reference-exact] [--output_dir out/] [--device cpu]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
from typing import Optional, Tuple

import numpy as np
import torch

from fast_neural_style_transfer_tpu_torch.infer.stylize import Stylizer
from fast_neural_style_transfer_tpu_torch.utils.image_io import (
    decode_image,
    denormalize_image,
    load_image,
    resize_image,
    save_image,
)
from fast_neural_style_transfer_tpu_torch.utils.ssim import ssim

THRESHOLD = 0.98


def _load_reference_net(reference_repo: str, pth_path: str) -> torch.nn.Module:
    """The reference's ``StyleTransferNet`` holding the ``.pth``'s weights
    (a state_dict or a training checkpoint's ``model_state_dict``), on the
    CPU in eval mode."""
    model_py = os.path.join(reference_repo, "models", "model.py")
    if not os.path.exists(model_py):
        raise FileNotFoundError(
            f"reference repo not found at {reference_repo} (need models/model.py)"
        )
    sys.path.insert(0, reference_repo)
    try:
        spec = importlib.util.spec_from_file_location("fnst_ref_model", model_py)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(reference_repo)

    net = mod.StyleTransferNet()
    ckpt = torch.load(pth_path, map_location="cpu", weights_only=False)
    state = ckpt.get("model_state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    net.load_state_dict(state, strict=True)
    net.eval()
    return net


def run_parity(
    reference_pth: str,
    content: str,
    *,
    reference_repo: str,
    size: Tuple[int, int] = (256, 256),
    mode: str = "reference-exact",
    output_dir: Optional[str] = None,
    reference_sample: Optional[str] = None,
    device: Optional[str] = None,
) -> dict:
    """The parity record (JAX's keys: ``metric``, ``value``, ``threshold``,
    ``mode``, ``size``, ``pass``, and ``ssim_vs_sample_file`` with
    ``reference_sample``). ``device``: the port's side (None: the card)."""
    if mode not in ("reference-exact", "canonical"):
        raise ValueError(f"unknown mode {mode!r}")

    # one input feeds both nets (NHWC float32, batch 1)
    x = load_image(content, size, normalize=(mode == "canonical"))

    ref_net = _load_reference_net(reference_repo, reference_pth)
    with torch.no_grad():
        ref_out = ref_net(torch.from_numpy(np.transpose(x, (0, 3, 1, 2)).copy()))
    ref_img = denormalize_image(np.transpose(ref_out.numpy(), (0, 2, 3, 1))[0])

    stylizer = Stylizer.from_checkpoint(reference_pth, device=device)
    our_img = denormalize_image(stylizer(x)[0])

    result = {
        "metric": "ssim_vs_reference_net",
        "value": round(ssim(our_img, ref_img), 6),
        "threshold": THRESHOLD,
        "mode": mode,
        "size": list(size),
        "pass": None,
    }
    result["pass"] = bool(result["value"] >= result["threshold"])

    if reference_sample:
        samp = decode_image(reference_sample)
        if samp.shape[:2] != our_img.shape[:2]:
            samp = resize_image(samp, our_img.shape[:2])
        result["ssim_vs_sample_file"] = round(ssim(our_img, samp / 255.0), 6)
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        save_image(our_img, os.path.join(output_dir, "parity_ours.jpg"),
                   denormalize=False)
        save_image(ref_img, os.path.join(output_dir, "parity_reference.jpg"),
                   denormalize=False)
    return result


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="SSIM parity: the port's stylizer vs the reference's own net "
                    "running the same .pth"
    )
    p.add_argument("--reference_pth", type=str, required=True,
                   help="Reference checkpoint (.pth: state_dict or training "
                        "checkpoint dict)")
    p.add_argument("--content", type=str, required=True,
                   help="Content image both pipelines stylize")
    p.add_argument("--size", type=int, nargs=2, default=[256, 256],
                   metavar=("H", "W"))
    p.add_argument("--mode", type=str, default="reference-exact",
                   choices=["reference-exact", "canonical"],
                   help="Input preprocessing (see module docstring)")
    p.add_argument("--reference_repo", type=str, required=True,
                   help="Path to the reference repository checkout "
                        "(the one holding models/model.py)")
    p.add_argument("--output_dir", type=str, default=None,
                   help="Also save both stylized outputs here")
    p.add_argument("--reference_sample", type=str, default=None,
                   help="Optional committed reference output file to score "
                        "our output against directly")
    p.add_argument("--device", type=str, default=None,
                   help="The port's side: cuda (default) or cpu")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    result = run_parity(
        args.reference_pth,
        args.content,
        reference_repo=args.reference_repo,
        size=tuple(args.size),
        mode=args.mode,
        output_dir=args.output_dir,
        reference_sample=args.reference_sample,
        device=args.device,
    )
    print(json.dumps(result))
    return 0 if result["pass"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
