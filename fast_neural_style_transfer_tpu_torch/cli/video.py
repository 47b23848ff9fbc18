"""Video stylization CLI, with the JAX package's ``fnst-video`` flags.

    python -m fast_neural_style_transfer_tpu_torch.cli.video \\
        --model_path evidence/soak40k_r5/style_transfer_final.pth \\
        --content frames_dir_or_clip.gif --output out.gif

Runs on the card (``--device``, default cuda; ``--cpu`` for the CPU) with
frozen IN statistics (``infer/video.py``). Clips are frame directories or
animated GIFs. Prints a JSON summary.
"""

from __future__ import annotations

import argparse
import json


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="stylize a video clip (frame dir or GIF) with frozen IN statistics")
    p.add_argument("--model_path", type=str, required=True,
                   help="Stylizer weights: reference .pth or the JAX package's .npz")
    p.add_argument("--content", type=str, required=True,
                   help="Input clip: directory of frames, or an animated GIF")
    p.add_argument("--output", type=str, required=True,
                   help="Output: *.gif for an animation, else a frame directory")
    p.add_argument("--size", type=int, nargs=2, default=None,
                   metavar=("H", "W"), help="Resize frames before stylizing")
    p.add_argument("--precision", type=str, default="f32", choices=["f32", "bf16"])
    p.add_argument("--style_index", type=int, default=None,
                   help="Multi-style checkpoints: style row to bake")
    p.add_argument("--stats_blend", type=float, default=1.0,
                   help="1.0 = freeze IN statistics to the first frame (most "
                        "stable); 0.0 = per-frame normalization (flickers)")
    p.add_argument("--no_stabilize", action="store_true",
                   help="Disable stabilization entirely (A/B baseline)")
    p.add_argument("--batch_size", type=int, default=8, help="Frames per device batch")
    p.add_argument("--fps", type=float, default=12.0, help="GIF output frame rate")
    p.add_argument("--max_frames", type=int, default=None,
                   help="Only process the first N frames")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the card)")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (--device cpu)")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    from fast_neural_style_transfer_tpu_torch.infer.video import stylize_video_file

    summary = stylize_video_file(
        args.model_path, args.content, args.output,
        size=tuple(args.size) if args.size else None,
        precision=args.precision,
        style=args.style_index,
        stats_blend=args.stats_blend,
        stabilize=not args.no_stabilize,
        batch_size=args.batch_size,
        fps=args.fps,
        max_frames=args.max_frames,
        device="cpu" if args.cpu else args.device,
    )
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
