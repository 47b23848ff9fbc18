"""Command-line front ends (flag-compatible with the JAX package's).

Every one runs on the card by default. ``--data_parallel`` (inference and
AdaIN bulk jobs, ``fnst-serve``) splits batches over every visible card;
the trainers do so by themselves when there are several cards;
``--spatial N`` splits an image's rows over N ranks."""


def resolve_style_flags(style_index, style_blend):
    """The --style_index / --style_blend contract of every CLI: mutually
    exclusive; returns what ``Stylizer.from_checkpoint(style=...)`` takes
    (None when neither is given)."""
    if style_index is not None and style_blend is not None:
        raise ValueError("--style_index and --style_blend are mutually exclusive")
    return style_index if style_index is not None else style_blend
