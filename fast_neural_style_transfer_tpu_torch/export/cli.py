"""Export CLI, with the JAX package's flags plus ``--device`` / ``--cpu``:

    python -m fast_neural_style_transfer_tpu_torch.export.cli \\
        --model out/style_transfer_final.npz \\
        --onnx model.onnx --torchscript model_traced.pt --pth model.pth \\
        --hub-dir hub/

Writing the artifacts is host work, and they are the same whichever device
runs the command. The TorchScript archive is then loaded on the device
(default the card; ``--cpu`` for the CPU) and checked there against the
port's f32 ``Stylizer``.
"""

from __future__ import annotations

import argparse

# largest |difference| in network space of the TorchScript check forward
# against the port's f32 Stylizer, about half a uint8 level (one level is
# 1/255 over the ImageNet std, ~0.017): f32 sums in other orders through 14
# instance norms, and on the card cuDNN's own choice of f32 conv algorithms
# for the archive's NCHW tensors (2.2e-3 on the trained checkpoint, H100)
TORCHSCRIPT_TOL = 1e-2


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="export a trained stylizer")
    p.add_argument("--model", required=True,
                   help="params: the JAX package's .npz, or a reference .pth")
    p.add_argument("--onnx", help="write ONNX graph (opset 11) here")
    p.add_argument("--onnx-dynamic", action="store_true",
                   help="export with symbolic batch/height/width dims instead "
                        "of the reference's static 1x3x256x256")
    p.add_argument("--torchscript", help="write traced TorchScript .pt here")
    p.add_argument("--pth", help="write reference-layout torch checkpoint here")
    p.add_argument("--hub-dir", help="package a Hugging Face repo dir here")
    p.add_argument("--style-index", type=int, default=None,
                   help="Multi-style checkpoints: export this trained style "
                        "(baked into a standard single-style net)")
    p.add_argument("--style-blend", type=float, nargs="+", default=None, metavar="W",
                   help="Multi-style checkpoints: export a convex blend of "
                        "the trained styles (length-S weights)")
    p.add_argument("--device", default="cuda",
                   help="device of the TorchScript check forward (default: the card)")
    p.add_argument("--cpu", action="store_true", help="check on the CPU (--device cpu)")
    return p


def main(argv=None) -> list:
    p = build_parser()
    args = p.parse_args(argv)
    if args.onnx_dynamic and not args.onnx:
        p.error("--onnx-dynamic requires --onnx")
    if not (args.onnx or args.torchscript or args.pth or args.hub_dir):
        p.error("nothing to do: pass at least one of --onnx/--torchscript/--pth/--hub-dir")
    from fast_neural_style_transfer_tpu_torch.cli import resolve_style_flags

    try:
        style = resolve_style_flags(args.style_index, args.style_blend)
    except ValueError as e:
        p.error(str(e).replace("_", "-"))  # this CLI spells the flags with dashes
    from fast_neural_style_transfer_tpu_torch.infer.stylize import load_style_params

    params = load_style_params(args.model, style)
    device = "cpu" if args.cpu else args.device
    wrote = []
    if args.onnx:
        from fast_neural_style_transfer_tpu_torch.export.onnx_export import export_onnx

        shape = ("batch", 3, "height", "width") if args.onnx_dynamic else (1, 3, 256, 256)
        wrote.append(export_onnx(params, args.onnx, input_shape=shape))
    if args.torchscript:
        from fast_neural_style_transfer_tpu_torch.export.torchscript import (
            check_torchscript,
            export_torchscript,
        )

        wrote.append(export_torchscript(params, args.torchscript))
        err = check_torchscript(args.torchscript, params, device=device)
        print(f"torchscript check on {device}: max |diff| {err:.3g} against the "
              "port's f32 Stylizer")
        if not err <= TORCHSCRIPT_TOL:
            raise SystemExit(f"TorchScript check failed: {err} > {TORCHSCRIPT_TOL}")
    if args.pth:
        from fast_neural_style_transfer_tpu_torch.export.torch_convert import (
            save_torch_checkpoint,
        )

        save_torch_checkpoint(params, args.pth)
        wrote.append(args.pth)
    if args.hub_dir:
        from fast_neural_style_transfer_tpu_torch.export.hf import package_for_hub

        wrote.append(package_for_hub(params, args.hub_dir))
    for w in wrote:
        print(f"wrote {w}")
    return wrote


if __name__ == "__main__":
    main()
