"""Canonical image IO and preprocessing, one convention everywhere:

    uint8 HWC RGB  --/255-->  [0,1]  --(x-mean)/std-->  network space
    network space  --x*std+mean-->  clamp [0,1]  --*255+0.5-->  uint8

The numpy functions work on host arrays; ``u8_to_network`` and
``network_to_u8`` are their tensor versions, run on whatever device the
tensor lies on (the on-device leg of the uint8 transport path).
"""

from __future__ import annotations

import functools
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)
IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg")


def scan_image_files(root: str) -> List[str]:
    """Every .png/.jpg/.jpeg under ``root``, in a sorted, stable order."""
    files: List[str] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        for fn in sorted(filenames):
            if fn.lower().endswith(IMAGE_EXTENSIONS):
                files.append(os.path.join(dirpath, fn))
    return files


def decode_image(path: str) -> np.ndarray:
    """Decode an image file to uint8 HWC RGB."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.uint8)


def resize_image(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize of uint8 HWC to (h, w) with PIL."""
    from PIL import Image

    h, w = size
    if img.shape[:2] == (h, w):
        return img
    return np.asarray(
        Image.fromarray(img).resize((w, h), Image.BILINEAR), np.uint8
    )


def normalize_image(img_u8: np.ndarray) -> np.ndarray:
    """uint8 HWC/NHWC -> ImageNet-normalized float32 (the network's space)."""
    x = img_u8.astype(np.float32) / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD


@functools.lru_cache(maxsize=None)
def mean_std(device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ImageNet mean and std on ``device``, made once per device: a
    CUDA graph's capture refuses the host-to-device copy that makes them."""
    with torch.inference_mode(False):  # plain tensors, usable by autograd too
        return (torch.as_tensor(IMAGENET_MEAN, device=device),
                torch.as_tensor(IMAGENET_STD, device=device))


def u8_to_unit(x_u8: torch.Tensor) -> torch.Tensor:
    """uint8 tensor -> float32 in [0, 1], on x's device, a true division on
    every device as on the CPU: with a Python number as the divisor CUDA
    multiplies by its float reciprocal instead, one ulp off for 126 of the
    256 values."""
    return x_u8.float() / torch.full((), 255.0, device=x_u8.device)


def u8_to_network(x_u8: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC tensor -> float32 network space, on x's device."""
    mean, std = mean_std(x_u8.device)
    return (u8_to_unit(x_u8) - mean) / std


def unit_to_u8(y: torch.Tensor) -> torch.Tensor:
    """[0, 1]-space tensor -> uint8 (clip, round by +0.5 and truncation),
    on y's device."""
    return (torch.clamp(y.float(), 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


def network_to_u8(y: torch.Tensor) -> torch.Tensor:
    """Network-space NHWC tensor -> uint8 (de-normalize, then
    ``unit_to_u8``), on y's device."""
    mean, std = mean_std(y.device)
    return unit_to_u8(y.float() * std + mean)


def denormalize_image(x: np.ndarray) -> np.ndarray:
    """Network space -> float32 [0,1] (de-normalize + clamp)."""
    x = np.asarray(x, np.float32) * IMAGENET_STD + IMAGENET_MEAN
    return np.clip(x, 0.0, 1.0)


def load_image(
    path: str,
    size: Optional[Tuple[int, int]] = None,
    *,
    normalize: bool = True,
    batch: bool = True,
) -> np.ndarray:
    """Decode + optional resize + canonical normalize; returns NHWC float32."""
    img = decode_image(path)
    if size is not None:
        img = resize_image(img, size)
    x = normalize_image(img) if normalize else img.astype(np.float32) / 255.0
    return x[None] if batch else x


def save_image(x: np.ndarray, path: str, *, denormalize: bool = True) -> None:
    """Save a (1,H,W,C) or (H,W,C) network-space or [0,1] image as a file."""
    from PIL import Image

    x = np.asarray(x)
    if x.ndim == 4:
        x = x[0]
    x = denormalize_image(x) if denormalize else np.clip(x, 0.0, 1.0)
    Image.fromarray((x * 255.0 + 0.5).astype(np.uint8)).save(path)
