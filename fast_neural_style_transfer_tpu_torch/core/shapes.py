"""Shape bucketing and device selection.

Arbitrary-resolution inference reflect-pads inputs up to a shape bucket
(a multiple of 64 by default) and crops the output back, so the serving
batcher can stack mixed sizes and cuDNN sees a bounded set of shapes.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F


def round_up_to_multiple(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def bucket_hw(h: int, w: int, multiple: int = 64) -> Tuple[int, int]:
    """Pick the padded (H, W) bucket for an input of size (h, w).

    The encoder/decoder is an exact 4x down/up pipeline, so any multiple of
    4 round-trips exactly; the coarser default bounds the distinct shapes.
    """
    if multiple % 4 != 0:
        raise ValueError("bucket multiple must be divisible by 4 for exact 4x round-trip")
    return round_up_to_multiple(max(h, 4), multiple), round_up_to_multiple(max(w, 4), multiple)


def pad_to_multiple_reflect(
    x: torch.Tensor, multiple: int = 64
) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """Reflect-pad an NHWC batch up to the (H, W) bucket.

    Returns the padded batch and the original (h, w) for cropping the output.
    Reflect padding requires pad < dim; for tiny images fall back to edge
    (replicate) mode.
    """
    _, h, w, _ = x.shape
    ph, pw = bucket_hw(h, w, multiple)
    dh, dw = ph - h, pw - w
    if dh == 0 and dw == 0:
        return x, (h, w)
    mode = "reflect" if (dh < h and dw < w) else "replicate"
    # F.pad pads trailing dims first: view NHWC as NCHW for the pad. Integer
    # tensors go through float32 (exact for u8) since pad modes need floats.
    dtype = x.dtype
    xc = x.permute(0, 3, 1, 2)
    if not dtype.is_floating_point:
        xc = xc.float()
    xc = F.pad(xc, (0, dw, 0, dh), mode=mode)
    return xc.to(dtype).permute(0, 2, 3, 1).contiguous(), (h, w)


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """``None`` means the card. A CUDA device with no card raises: the port
    never carries on quietly on the CPU unless the caller asked for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


def indexed_device(device: torch.device) -> torch.device:
    """``device`` with its index: "cuda" is the current card, "cuda:N"; the
    tensors made on it report that, and replicas are keyed by it."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device
