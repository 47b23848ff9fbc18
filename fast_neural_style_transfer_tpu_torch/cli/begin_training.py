"""Training CLI, with the JAX package's flags plus ``--device``.

    python -m fast_neural_style_transfer_tpu_torch.cli.begin_training \\
        --dataset_dir data/train --style_image style.jpg \\
        --total_steps 80000 --output_dir training_output

Runs on the card (``--device cpu`` for the CPU). Several ``--style_image``
paths train one multi-style net (conditional IN); ``--in_stats onepass``
trains with one-pass IN statistics; a reference training ``.pth`` as
``--checkpoint_path`` resumes fully (Adam state, schedule, iteration).
With several cards (``--device cuda``) the loop spawns a rank a card and
splits the batch over them (data parallelism, ``train/step.py``; an
explicit ``--device cuda:N`` is that one card); ``--spatial N`` splits
each image's rows over N of the ranks (``train/loop.py``,
``train/spatial_step.py``). ``--profile_start`` / ``--profile_stop`` trace
with ``torch.profiler``.
"""

from __future__ import annotations

import argparse

from fast_neural_style_transfer_tpu_torch.cli.config import (
    dataset_dir,
    loss_weights_config,
    output_dir,
    style_image,
    training_config,
    training_monitor_content_image,
    vgg19_weights,
    vgg_loss_layers,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="train fast neural style transfer (PyTorch/CUDA)")
    p.add_argument("--style_image", type=str, nargs="+", default=style_image,
                   help="Path to the style image; several train one "
                        "multi-style net (conditional instance norm)")
    p.add_argument("--training_monitor_content_image", type=str,
                   default=training_monitor_content_image,
                   help="Path to content image to monitor training")
    p.add_argument("--dataset_dir", type=str, default=dataset_dir,
                   help="Path to content dataset directory")
    p.add_argument("--output_dir", type=str, default=output_dir,
                   help="Directory for checkpoints, samples, final model")
    p.add_argument("--content_weight", type=float,
                   default=loss_weights_config["CONTENT_WEIGHT"],
                   help="Weight for content loss")
    p.add_argument("--style_weight", type=float,
                   default=loss_weights_config["STYLE_WEIGHT"],
                   help="Weight for style loss")
    p.add_argument("--tv_weight", type=float, default=loss_weights_config["TV_WEIGHT"],
                   help="Weight for total variation loss")
    p.add_argument("--num_epochs", type=int, default=None,
                   help="Additional bound: stop after N dataset epochs "
                        "(default: step-bounded only)")
    p.add_argument("--batch_size", type=int, default=training_config["BATCH_SIZE"],
                   help="Batch size")
    p.add_argument("--total_steps", type=int, default=training_config["TOTAL_STEPS"],
                   help="Total training steps")
    p.add_argument("--lr", type=float, default=training_config["LEARNING_RATE"],
                   help="Learning rate (cosine-annealed to 1e-7)")
    p.add_argument("--checkpoint_path", type=str, default=None,
                   help="Warm start: stylizer weights (.npz or reference .pth); "
                        "a reference training .pth resumes fully")
    p.add_argument("--vgg_weights", type=str, default=vgg19_weights,
                   help="VGG19 ImageNet weights (.npz or torchvision .pth)")
    p.add_argument("--precision", type=str, default="f32", choices=["f32", "bf16"],
                   help="Compute precision")
    p.add_argument("--num_workers", type=int, default=8,
                   help="Host image-decode threads")
    p.add_argument("--weight_decay_every", type=int, default=10_000,
                   help="Halve content / double style weight every N steps (0=off)")
    p.add_argument("--grad_accum", type=int, default=1,
                   help="Average gradients over N micro-batches per optimizer update")
    p.add_argument("--spatial", type=int, default=1,
                   help="Split each image's rows over N ranks (processes)")
    p.add_argument("--remat", action="store_true",
                   help="Recompute the stylizer and the stylized-branch VGG in "
                        "the backward (torch.utils.checkpoint)")
    p.add_argument("--in_stats", choices=("stable", "onepass"), default="stable",
                   help="Instance-norm statistics: 'onepass' computes mean and "
                        "E[x^2] from one read")
    p.add_argument("--pad_batch", action="store_true",
                   help="Pad the batch to a multiple of 8 with loss-masked "
                        "copies (gradients stay the real batch's)")
    p.add_argument("--image_size", type=int, nargs=2, default=None, metavar=("H", "W"),
                   help="Training crop size (default: config TRAIN_IMAGE_SHAPE)")
    p.add_argument("--content_tap", type=str, default=None,
                   help="VGG19 content tap name (default relu4_2)")
    p.add_argument("--reference_taps", action="store_true",
                   help="Use the reference's actual content tap relu4_3")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--profile_start", type=int, default=0,
                   help="Start a torch.profiler trace at this step; besides the "
                        "operators and kernels it carries the step's spans "
                        "train.loss, train.grad, train.sync, train.update and "
                        "the input wait pipeline.wait")
    p.add_argument("--profile_stop", type=int, default=0,
                   help="Stop the trace at this step (writes <output_dir>/profile)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default: the card; 'cpu' to run there)")
    return p


def main(argv=None) -> str:
    args = build_parser().parse_args(argv)
    style = args.style_image
    if isinstance(style, list):
        style = style[0] if len(style) == 1 else tuple(style)

    from fast_neural_style_transfer_tpu_torch.train.loop import (
        TrainConfig,
        train_style_transfer,
    )

    cfg = TrainConfig(
        style_image=style,
        dataset_dir=args.dataset_dir,
        output_dir=args.output_dir,
        vgg_weights=args.vgg_weights,
        monitor_image=args.training_monitor_content_image,
        total_steps=args.total_steps,
        num_epochs=args.num_epochs,
        batch_size=args.batch_size,
        lr=args.lr,
        image_size=tuple(args.image_size) if args.image_size
        else tuple(training_config["TRAIN_IMAGE_SHAPE"]),
        content_weight=args.content_weight,
        style_weight=args.style_weight,
        tv_weight=args.tv_weight,
        weight_decay_every=args.weight_decay_every,
        grad_accum=args.grad_accum,
        content_tap=args.content_tap
        or ("relu4_3" if args.reference_taps else vgg_loss_layers["CONTENT_LAYER"]),
        style_taps=tuple(vgg_loss_layers["STYLE_LAYERS"]),
        style_tap_weights=tuple(vgg_loss_layers["STYLE_LAYER_WEIGHTS"]),
        precision=args.precision,
        seed=args.seed,
        num_workers=args.num_workers,
        remat=args.remat,
        in_stats=args.in_stats,
        pad_batch=args.pad_batch,
        init_checkpoint=args.checkpoint_path,
        profile_start=args.profile_start,
        profile_stop=args.profile_stop,
        device=args.device,
        spatial=args.spatial,
    )
    return train_style_transfer(cfg)


if __name__ == "__main__":
    main()
