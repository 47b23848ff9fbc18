"""Colour control (the JAX package's ``utils/color.py``):

- ``match_color``: map the style image's pixels so their RGB mean and
  covariance equal the content's (the AdaIN paper's §7.2), before encoding
  the style;
- ``luminance_transfer``: keep the stylized luminance and take the
  chrominance from the content, in YIQ (Gatys et al. colour control,
  option 2), after stylizing.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

# NTSC YIQ <-> RGB (the classic luminance/chrominance split)
_RGB2YIQ = (
    (0.299, 0.587, 0.114),
    (0.595716, -0.274453, -0.321263),
    (0.211456, -0.522591, 0.311135),
)
# its float32 inverse, as the JAX package's LU inverse rounds it (the
# exported colour graph carries these bits)
_YIQ2RGB = (
    (0.99999994, 0.9562958, 0.6210244),
    (0.99999994, -0.27212206, -0.6473806),
    (0.9999999, -1.106989, 1.7046151),
)


@functools.lru_cache(maxsize=None)
def _yiq(device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(RGB -> YIQ, YIQ -> RGB) on ``device``, made once per device: a CUDA
    graph's capture refuses the host-to-device copy that makes them."""
    with torch.inference_mode(False):  # plain tensors, usable by autograd too
        return tuple(torch.tensor(m, dtype=torch.float32, device=device)
                     for m in (_RGB2YIQ, _YIQ2RGB))


def luminance_transfer(stylized: torch.Tensor, content: torch.Tensor) -> torch.Tensor:
    """Stylized luminance + content chrominance, NHWC in and out, dtype
    preserved. The luminance channel is shifted to the content's mean/std
    first, so overall brightness stays the content's."""
    if stylized.shape != content.shape:
        raise ValueError(
            f"stylized {tuple(stylized.shape)} and content "
            f"{tuple(content.shape)} must match for luminance transfer")
    rgb2yiq, yiq2rgb = _yiq(stylized.device)
    s = stylized.float() @ rgb2yiq.T
    c = content.float() @ rgb2yiq.T
    y_s, y_c = s[..., :1], c[..., :1]
    axes = tuple(range(1, y_s.ndim - 1))
    mu_s = y_s.mean(dim=axes, keepdim=True)
    mu_c = y_c.mean(dim=axes, keepdim=True)
    sd_s = y_s.std(dim=axes, keepdim=True, unbiased=False) + 1e-6
    sd_c = y_c.std(dim=axes, keepdim=True, unbiased=False)
    y = (y_s - mu_s) / sd_s * sd_c + mu_c
    out = torch.cat([y, c[..., 1:]], dim=-1) @ yiq2rgb.T
    return out.to(stylized.dtype)


def _mean_cov(x: torch.Tensor, eps: float):
    """Per-image RGB mean (B, 1, 3) and covariance (B, 3, 3) over H*W."""
    flat = x.reshape(x.shape[0], -1, 3).float()
    mean = flat.mean(dim=1, keepdim=True)
    centered = flat - mean
    cov = centered.transpose(1, 2) @ centered / centered.shape[1]
    return flat, mean, cov + eps * torch.eye(3, device=x.device)


def _cov_sqrt(cov: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Symmetric (inverse) square root of a batch of SPD 3x3 matrices."""
    vals, vecs = torch.linalg.eigh(cov)
    vals = torch.clamp(vals, min=1e-12)
    d = 1.0 / torch.sqrt(vals) if inverse else torch.sqrt(vals)
    return (vecs * d[:, None, :]) @ vecs.transpose(1, 2)


def match_color(source: torch.Tensor, target: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """Affine-map ``source``'s pixels so their RGB mean and covariance equal
    ``target``'s (whitening, then colouring). NHWC in and out, dtype kept;
    ``target`` may differ in H, W, or have a batch of 1."""
    if source.dim() != 4 or target.dim() != 4:
        raise ValueError("match_color expects NHWC batches")
    s_flat, s_mean, s_cov = _mean_cov(source, eps)
    _, t_mean, t_cov = _mean_cov(target, eps)
    a = _cov_sqrt(t_cov) @ _cov_sqrt(s_cov, inverse=True)
    out = (s_flat - s_mean) @ a.transpose(1, 2) + t_mean
    return out.reshape(source.shape).to(source.dtype)
