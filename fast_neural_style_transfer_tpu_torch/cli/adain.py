"""AdaIN CLI, with the JAX package's ``fnst-adain`` flags: train the
arbitrary-style decoder, or stylize with any style image.

    python -m fast_neural_style_transfer_tpu_torch.cli.adain train \\
        --content_dir coco/ --style_dir wikiart/ --output_dir out
    python -m fast_neural_style_transfer_tpu_torch.cli.adain stylize \\
        --decoder out/adain_decoder_final.npz --content_image photo.jpg \\
        --style_image painting.jpg --output stylized.jpg --alpha 0.8

    python -m fast_neural_style_transfer_tpu_torch.cli.adain export \\
        --decoder out/adain_decoder_final.npz --onnx adain.onnx \\
        --torchscript adain.pt

Runs on the card (``--device``, default cuda; ``--cpu`` for the CPU).
``export`` writes the two-input ONNX graph (or, with ``--style_image``, a
content-only one with the style baked in) and the two-input TorchScript
archive: host work, but for the baked styles' moments, which the VGG
encodes on the device. ``stylize --spatial N`` splits the content's rows
over N ranks (``infer/spatial_adain.py``; ``parallel/mesh.py::launch``
spawns them), single-image mode only, as the JAX package's.
``stylize --content_dir --data_parallel`` splits each batch over every
visible card (a replica on each, ``infer/adain.py``); ``train`` splits its
batch over every card by itself when there are several
(``train/adain.py``).
"""

from __future__ import annotations

import argparse

from fast_neural_style_transfer_tpu_torch.models.adain import load_decoder


def _device_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the card)")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (--device cpu)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="AdaIN arbitrary-style transfer (train / stylize)")
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train", help="train the decoder")
    t.add_argument("--content_dir", required=True)
    t.add_argument("--style_dir", required=True,
                   help="Directory of style images (e.g. a painting corpus)")
    t.add_argument("--output_dir", default="adain_output")
    t.add_argument("--vgg_weights", default=None)
    t.add_argument("--total_steps", type=int, default=20_000)
    t.add_argument("--batch_size", type=int, default=8)
    t.add_argument("--lr", type=float, default=1e-4)
    t.add_argument("--remat", action="store_true",
                   help="Recompute the decoder and the output-VGG forwards in "
                        "the backward (torch.utils.checkpoint)")
    t.add_argument("--lr_decay", type=float, default=5e-5,
                   help="Inverse-time lr decay lr/(1+decay*step), the paper's "
                        "recipe; 0 = constant lr")
    t.add_argument("--style_weight", type=float, default=10.0)
    t.add_argument("--image_size", type=int, nargs=2, default=(256, 256),
                   metavar=("H", "W"))
    t.add_argument("--precision", default="f32", choices=["f32", "bf16"])
    t.add_argument("--num_workers", type=int, default=8)
    t.add_argument("--checkpoint_every", type=int, default=2000)
    t.add_argument("--seed", type=int, default=0)
    _device_flags(t)

    s = sub.add_parser("stylize", help="stylize with an arbitrary style image")
    s.add_argument("--decoder", required=True,
                   help="trained decoder: the JAX package's .npz, or a torch .pth")
    s.add_argument("--content_image", default=None)
    s.add_argument("--content_dir", default=None,
                   help="Bulk mode: stylize every image under this directory "
                        "with the given style (pipelined batches)")
    s.add_argument("--batch_size", type=int, default=16, help="Bulk mode device batch size")
    s.add_argument("--data_parallel", action="store_true",
                   help="Bulk mode: shard batches over every visible card "
                        "(--batch_size must divide by their number)")
    s.add_argument("--skip_bad_images", action="store_true",
                   help="Bulk mode: log and skip undecodable files instead "
                        "of failing the whole job")
    s.add_argument("--style_image", required=True, nargs="+",
                   help="style image(s); several interpolate styles "
                        "(weights via --style_blend, default equal)")
    s.add_argument("--style_blend", type=float, nargs="+", default=None, metavar="W",
                   help="convex interpolation weights, one per style image")
    s.add_argument("--style_masks", nargs="+", default=None, metavar="MASK",
                   help="per-style grayscale mask images, one per "
                        "--style_image: paint each content region with its "
                        "own style (paper §7.3); resized to the content, "
                        "normalized per pixel. Exclusive with --style_blend; "
                        "single-image mode")
    s.add_argument("--output", default=None,
                   help="Output image path (single; default adain_stylized.jpg) "
                        "or directory (bulk; default <content_dir>_stylized)")
    s.add_argument("--alpha", type=float, default=1.0,
                   help="style strength in [0, 1] (0 = content reconstruction)")
    s.add_argument("--preserve_color", default="off", choices=["off", "match", "luma"],
                   help="keep the content's palette (paper §7.2): 'match' "
                        "re-colors the style image(s) to the content's RGB "
                        "mean/covariance before encoding; 'luma' keeps only "
                        "the stylized luminance ('luma' also works in bulk mode)")
    s.add_argument("--size", type=int, nargs=2, default=None, metavar=("H", "W"))
    s.add_argument("--vgg_weights", default=None)
    s.add_argument("--precision", default="f32", choices=["f32", "bf16"])
    s.add_argument("--spatial", type=int, default=1,
                   help="Split the content's rows over N ranks (processes)")
    _device_flags(s)

    e = sub.add_parser("export", help="export the full pipeline (ONNX / TorchScript)")
    e.add_argument("--decoder", required=True)
    e.add_argument("--onnx", default=None, help="output .onnx path")
    e.add_argument("--torchscript", default=None, help="output traced two-input .pt path")
    e.add_argument("--vgg_weights", default=None)
    e.add_argument("--alpha", default=1.0,
                   type=lambda s: s if s == "input" else float(s),
                   help="style strength baked into the graph, or the literal "
                        "'input' to expose a scalar alpha graph input (ONNX only)")
    e.add_argument("--content_shape", type=int, nargs=2, default=(256, 256),
                   metavar=("H", "W"))
    e.add_argument("--style_shape", type=int, nargs=2, default=(256, 256),
                   metavar=("H", "W"))
    e.add_argument("--style_image", nargs="+", default=None,
                   help="Bake these style image(s)' moments into the graph: "
                        "single-input artifact, no style branch (blend weights "
                        "via --style_blend)")
    e.add_argument("--style_blend", type=float, nargs="+", default=None, metavar="W")
    e.add_argument("--preserve_color", default="off", choices=["off", "luma"],
                   help="'luma' bakes Gatys color control into the ONNX graph: "
                        "the artifact's output keeps the content's chrominance "
                        "(ONNX-only)")
    _device_flags(e)
    return p


def _masks(paths, n_styles: int, hw):
    """Grayscale mask images -> (S, H, W) f32 in [0, 1] at the content's size."""
    import numpy as np
    from PIL import Image

    if len(paths) != n_styles:
        raise SystemExit(f"{len(paths)} --style_masks for {n_styles} --style_image")
    h, w = hw
    out = []
    for m in paths:
        with Image.open(m) as im:
            out.append(np.asarray(im.convert("L").resize((w, h), Image.BILINEAR),
                                  np.float32) / 255.0)
    return np.stack(out)


def _stylize_one_rank(plan, args) -> str:
    return _stylize_one(args, plan.device, plan)


def _stylize_one(args, device, plan=None) -> str:
    """One content image; with ``plan`` (``--spatial``) this rank's share of
    it, rank 0 writing the file."""
    import numpy as np
    import torch

    from fast_neural_style_transfer_tpu_torch.core.dtypes import canonical_compute_dtype, exact_f32
    from fast_neural_style_transfer_tpu_torch.core.shapes import (
        pad_to_multiple_reflect,
        resolve_device,
    )
    from fast_neural_style_transfer_tpu_torch.models.adain import (
        make_decoder,
        stylize_arbitrary,
    )
    from fast_neural_style_transfer_tpu_torch.models.vgg_weights import make_vgg, resolve_params
    from fast_neural_style_transfer_tpu_torch.utils import load_image, save_image
    from fast_neural_style_transfer_tpu_torch.utils.color import (
        luminance_transfer,
        match_color,
    )
    from fast_neural_style_transfer_tpu_torch.utils.image_io import mean_std

    out_path = args.output or "adain_stylized.jpg"
    dev = resolve_device(device)
    prec = canonical_compute_dtype(args.precision)
    exact_f32(dev, prec)
    vgg = make_vgg(resolve_params(args.vgg_weights), dev)
    decoder = make_decoder(load_decoder(args.decoder), dev).eval()
    size = tuple(args.size) if args.size else None
    content = torch.from_numpy(load_image(args.content_image, size)).to(dev)
    styles = [pad_to_multiple_reflect(torch.from_numpy(load_image(p, None)).to(dev), 8)[0]
              for p in args.style_image]
    if args.preserve_color == "match":
        styles = [match_color(s, content) for s in styles]
    # content H, W must divide 8 (VGG pools, decoder ups): reflect-pad up
    # and crop back
    content_orig = content
    content, (h, w) = pad_to_multiple_reflect(content, 8)
    masks = None
    if args.style_masks:
        masks = _masks(args.style_masks, len(styles), (h, w))
    if plan is not None:
        from fast_neural_style_transfer_tpu_torch.infer.spatial_adain import (
            stylize_arbitrary_spatial,
        )

        out = stylize_arbitrary_spatial(
            decoder, vgg, content_orig, styles, plan, alpha=args.alpha,
            style_weights=args.style_blend, style_masks=masks, precision=prec).float()
        if plan.space.index:
            return out_path
    else:
        if masks is not None:
            ph, pw = content.shape[1] - h, content.shape[2] - w
            if ph or pw:  # mirror the content's pad so mask pixels track it
                masks = np.pad(masks, ((0, 0), (0, ph), (0, pw)), mode="edge")
        with torch.inference_mode():
            out = stylize_arbitrary(decoder, vgg, content, styles, alpha=args.alpha,
                                    style_weights=args.style_blend, style_masks=masks,
                                    precision=prec)[:, :h, :w, :].float()
    with torch.inference_mode():
        if args.preserve_color == "luma":
            mean, std = mean_std(dev)
            out01 = luminance_transfer(out * std + mean, content_orig * std + mean)
            out = (out01 - mean) / std
    save_image(out.cpu().numpy(), out_path)
    print(f"saved {out_path}")
    return out_path


def _export(args, device: str) -> list:
    """The ``export`` subcommand: every flag combination is checked before
    any artifact is written."""
    if not args.onnx and not args.torchscript:
        raise SystemExit("pass --onnx and/or --torchscript")
    if args.style_blend and not args.style_image:
        raise SystemExit("--style_blend without --style_image does nothing: blend "
                         "weights only apply when baking style image(s) into the graph")
    if args.torchscript:
        if args.style_image:
            raise SystemExit("--style_image baking is ONNX-only; the TorchScript "
                             "artifact keeps the style as a runtime input")
        if args.preserve_color != "off":
            raise SystemExit("--preserve_color is ONNX-only")
        if args.alpha == "input":
            raise SystemExit("--alpha input is ONNX-only; TorchScript traces bake "
                             "the strength")
    import torch

    from fast_neural_style_transfer_tpu_torch.core.dtypes import Precision, exact_f32
    from fast_neural_style_transfer_tpu_torch.core.shapes import (
        pad_to_multiple_reflect,
        resolve_device,
    )
    from fast_neural_style_transfer_tpu_torch.export.onnx_adain import export_adain_onnx
    from fast_neural_style_transfer_tpu_torch.models.adain import blended_style_stats
    from fast_neural_style_transfer_tpu_torch.models.vgg_weights import make_vgg, resolve_params
    from fast_neural_style_transfer_tpu_torch.utils import load_image

    vgg_params = resolve_params(args.vgg_weights)
    baked = None
    if args.style_image:
        dev = resolve_device(device)
        exact_f32(dev, Precision.f32())
        vgg = make_vgg(vgg_params, dev)
        styles = [pad_to_multiple_reflect(torch.from_numpy(load_image(p, None)).to(dev), 8)[0]
                  for p in args.style_image]
        with torch.inference_mode():
            baked = tuple(t.cpu() for t in blended_style_stats(vgg, styles, args.style_blend))
    decoder = load_decoder(args.decoder)
    wrote = []
    if args.onnx:
        export_adain_onnx(decoder, vgg_params, args.onnx, alpha=args.alpha,
                          content_shape=(1, 3, *args.content_shape),
                          style_shape=(1, 3, *args.style_shape),
                          baked_style=baked, preserve_color=args.preserve_color)
        print(f"wrote {args.onnx}"
              + (" (baked style, single input)" if baked is not None else ""))
        wrote.append(args.onnx)
    if args.torchscript:
        from fast_neural_style_transfer_tpu_torch.export.torch_adain import (
            export_adain_torchscript,
        )

        export_adain_torchscript(decoder, vgg_params, args.torchscript, alpha=args.alpha)
        print(f"wrote {args.torchscript}")
        wrote.append(args.torchscript)
    return wrote


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = "cpu" if args.cpu else args.device

    if args.cmd == "train":
        from fast_neural_style_transfer_tpu_torch.train.adain import (
            AdaINTrainConfig,
            train_adain,
        )

        return train_adain(AdaINTrainConfig(
            content_dir=args.content_dir,
            style_dir=args.style_dir,
            output_dir=args.output_dir,
            vgg_weights=args.vgg_weights,
            total_steps=args.total_steps,
            batch_size=args.batch_size,
            lr=args.lr,
            lr_decay=args.lr_decay,
            remat=args.remat,
            style_weight=args.style_weight,
            image_size=tuple(args.image_size),
            precision=args.precision,
            num_workers=args.num_workers,
            checkpoint_every=args.checkpoint_every,
            seed=args.seed,
            device=device,
        ))

    if args.cmd == "export":
        return _export(args, device)

    # stylize
    if (args.content_image is None) == (args.content_dir is None):
        raise SystemExit("pass exactly one of --content_image (single) or "
                         "--content_dir (bulk)")
    if args.spatial > 1:
        if args.content_dir is not None:
            raise SystemExit("--content_dir and --spatial cannot be combined yet; "
                             "run spatial jobs per image, or use --data_parallel "
                             "to use every card on directory batches")
        from fast_neural_style_transfer_tpu_torch.core.shapes import resolve_device
        from fast_neural_style_transfer_tpu_torch.parallel import launch

        return launch(_stylize_one_rank, args.spatial, (args,),
                      device=resolve_device(device).type, deadline_s=float("inf"))[0]
    if args.content_dir is None:
        return _stylize_one(args, device)
    if args.preserve_color == "match":
        raise SystemExit(
            "--preserve_color match is per-content (it re-colors the style "
            "pixels) and cannot use the bulk cached-style engine; 'luma' works "
            "in bulk, or run 'match' per image")
    if args.style_masks:
        raise SystemExit("--style_masks applies to single-image mode")
    from fast_neural_style_transfer_tpu_torch.infer.adain import stylize_directory_arbitrary

    written = stylize_directory_arbitrary(
        args.decoder, args.content_dir,
        args.output or args.content_dir.rstrip("/") + "_stylized",
        args.style_image, style_weights=args.style_blend, alpha=args.alpha,
        vgg_weights=args.vgg_weights, size=tuple(args.size) if args.size else None,
        batch_size=args.batch_size, precision=args.precision,
        data_parallel=args.data_parallel, skip_bad_images=args.skip_bad_images,
        preserve_color=args.preserve_color, device=device)
    done = [w for w in written if w]
    print(f"stylized {len(done)} images"
          + (f" ({len(written) - len(done)} skipped)" if len(done) != len(written) else ""))
    return written


if __name__ == "__main__":
    main()
