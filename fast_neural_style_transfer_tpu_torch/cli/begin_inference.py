"""Inference CLI, with the JAX package's flags.

    python -m fast_neural_style_transfer_tpu_torch.cli.begin_inference \\
        --model_path evidence/soak40k_r5/style_transfer_final.pth \\
        --content_image photo.jpg --output_dir out

Single images and ``--content_dir`` jobs run on the card (``--device``).
``--style_index`` / ``--style_blend`` pick or blend the styles of a
multi-style checkpoint. ``--precision int8`` quantizes the convs
(``infer/quantized.py``). ``--spatial N`` splits one image's rows over N
ranks (``infer/spatial.py``; ``parallel/mesh.py::launch`` spawns them: NCCL
with a card each, gloo where they share one or run on the CPU); it refuses
int8 and ``--content_dir``, as the JAX package's does. ``--content_dir
--data_parallel`` splits each batch over every visible card (``--device
cuda``; an explicit ``cuda:N`` or ``cpu`` is that one device), a replica
of the params on each (``infer/stylize.py``); ``--batch_size`` must divide
by their number.
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
                   help="Shard --content_dir batches over every visible card "
                        "(--batch_size must divide by their number)")
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
                   help="Split the image's rows over N ranks (processes)")
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
    if args.spatial > 1:
        if args.content_dir:
            raise SystemExit(
                "--content_dir and --spatial cannot be combined yet; run spatial "
                "jobs per image, or use --data_parallel to use every card on "
                "directory batches")
        if args.precision == "int8":
            raise SystemExit("--precision int8 is not supported with --spatial "
                             "(the halo-exchange forward is float-only)")
        from fast_neural_style_transfer_tpu_torch.core.shapes import resolve_device
        from fast_neural_style_transfer_tpu_torch.parallel import launch

        dev = resolve_device(args.device)
        out_path = launch(_spatial_rank, args.spatial, (vars(args), style, size),
                          device=dev.type, deadline_s=float("inf"))[0]
        print(f"saved {out_path}")
        return
    if args.content_dir:
        written = stylize_directory(
            args.model_path, args.content_dir, args.output_dir,
            size=size, batch_size=args.batch_size, precision=args.precision,
            data_parallel=args.data_parallel, style=style,
            skip_bad_images=args.skip_bad_images,
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


def _spatial_rank(plan, opts: dict, style, size) -> str:
    """One rank of ``--spatial``: the whole image in, this rank's rows
    stylized, the output gathered; rank 0 writes the file."""
    import torch

    from fast_neural_style_transfer_tpu_torch.core.dtypes import canonical_compute_dtype, exact_f32
    from fast_neural_style_transfer_tpu_torch.infer.spatial import stylize_spatial
    from fast_neural_style_transfer_tpu_torch.infer.stylize import load_style_params
    from fast_neural_style_transfer_tpu_torch.models.transformer import TransformerNet
    from fast_neural_style_transfer_tpu_torch.utils import load_image, save_image

    prec = canonical_compute_dtype(opts["precision"])
    exact_f32(plan.device, prec)
    net = TransformerNet()
    net.load_state_dict(load_style_params(opts["model_path"], style), strict=True)
    net = net.eval().to(plan.device, memory_format=torch.channels_last)
    x = torch.from_numpy(load_image(opts["content_image"], size)).to(plan.device)
    out = stylize_spatial(net, x, plan, precision=prec).float()
    path = os.path.join(opts["output_dir"], opts["output_name"])
    if plan.space.index == 0:
        if opts["preserve_color"] == "luma":
            from fast_neural_style_transfer_tpu_torch.utils.color import luminance_transfer
            from fast_neural_style_transfer_tpu_torch.utils.image_io import mean_std

            mean, std = mean_std(out.device)
            out01 = luminance_transfer(out * std + mean, x * std + mean)
            out = (out01 - mean) / std
        save_image(out.cpu().numpy(), path)
    return path


if __name__ == "__main__":
    main()
