"""What a run must refuse: a missing card, and any module of JAX or of the
JAX package in the process once the window has closed."""

import sys

# whole top-level names: the port's package name begins with the last one
FORBIDDEN = ("jax", "jaxlib", "flax", "fast_neural_style_transfer_tpu")


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name (before the first dot) is a
    forbidden one."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)


def require_cards(chips: int) -> None:
    """Exit non-zero, with no result, unless ``chips`` CUDA cards are there."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("port_bench: no CUDA device is available; the benchmark "
                         "runs only on the card")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"port_bench: the cell needs {chips} cards, "
                         f"{torch.cuda.device_count()} are visible")
