"""Inference CLI, with the JAX package's flags.

    python -m fast_neural_style_transfer_tpu_torch.cli.begin_inference \\
        --model_path evidence/soak40k_r5/style_transfer_final.pth \\
        --content_image photo.jpg --output_dir out

Single images and ``--content_dir`` jobs run on the card (``--device``).
``--style_index`` / ``--style_blend`` pick or blend the styles of a
multi-style checkpoint. ``--precision int8`` quantizes the convs
(``infer/quantized.py``). ``--spatial > 1`` and ``--data_parallel`` are not
yet ported and exit with a message.
"""

from __future__ import annotations

import argparse
import os

from fast_neural_style_transfer_tpu_torch.cli import resolve_style_flags
from fast_neural_style_transfer_tpu_torch.cli.config import (
    inference_content_image,
    output_dir,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="fast neural style transfer inference (PyTorch/CUDA)")
    p.add_argument("--output_dir", type=str, default=output_dir,
                   help="Directory to save results")
    p.add_argument("--content_image", type=str, default=inference_content_image,
                   help="Content image for inference")
    p.add_argument("--content_dir", type=str, default=None,
                   help="Stylize every image under this directory instead "
                        "(batched on device; outputs <relpath>_stylized.jpg, "
                        "subdirectories mirrored)")
    p.add_argument("--batch_size", type=int, default=16,
                   help="Device batch size for --content_dir jobs")
    p.add_argument("--data_parallel", action="store_true",
                   help="Shard --content_dir batches over several cards "
                        "(not yet ported)")
    p.add_argument("--skip_bad_images", action="store_true",
                   help="--content_dir jobs: log and skip undecodable files "
                        "instead of failing the whole job")
    p.add_argument("--model_path", type=str, default="model_weights",
                   help="Model weights: reference .pth or the JAX package's .npz")
    p.add_argument("--output_name", type=str, default="stylized_output.jpg",
                   help="Output filename")
    p.add_argument("--size", type=int, nargs=2, default=None, metavar=("H", "W"),
                   help="Optional resize; default keeps the native resolution")
    p.add_argument("--precision", type=str, default="f32",
                   choices=["f32", "bf16", "int8"],
                   help="compute dtype (int8: quantized convs, float32 elsewhere)")
    p.add_argument("--spatial", type=int, default=1,
                   help="Shard image height over N devices (not yet ported)")
    p.add_argument("--style_index", type=int, default=None,
                   help="Multi-style checkpoints: which trained style to use")
    p.add_argument("--style_blend", type=float, nargs="+", default=None,
                   metavar="W",
                   help="Multi-style checkpoints: length-S weights that "
                        "convexly blend the trained styles (e.g. 0.5 0.5)")
    p.add_argument("--preserve_color", default="off", choices=["off", "luma"],
                   help="'luma' keeps only the stylized luminance and takes "
                        "chrominance from the content")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default: the card; 'cpu' to run there)")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.spatial > 1:
        raise SystemExit("--spatial > 1: spatial sharding is not yet ported")
    if args.data_parallel:
        raise SystemExit("--data_parallel: multi-card inference is not yet ported")

    from fast_neural_style_transfer_tpu_torch.infer import (
        stylize_directory,
        stylize_image_file,
    )

    try:
        style = resolve_style_flags(args.style_index, args.style_blend)
    except ValueError as e:
        raise SystemExit(str(e))
    size = tuple(args.size) if args.size else None
    os.makedirs(args.output_dir, exist_ok=True)
    if args.content_dir:
        written = stylize_directory(
            args.model_path, args.content_dir, args.output_dir,
            size=size, batch_size=args.batch_size, precision=args.precision,
            style=style, skip_bad_images=args.skip_bad_images,
            preserve_color=args.preserve_color, device=args.device)
        done = [w for w in written if w]
        print(f"saved {len(done)} stylized images to {args.output_dir}"
              + (f" ({len(written) - len(done)} skipped)"
                 if len(done) != len(written) else ""))
        return
    out_path = stylize_image_file(
        args.model_path, args.content_image,
        os.path.join(args.output_dir, args.output_name),
        size=size, precision=args.precision, style=style,
        preserve_color=args.preserve_color, device=args.device)
    print(f"saved {out_path}")


if __name__ == "__main__":
    main()
