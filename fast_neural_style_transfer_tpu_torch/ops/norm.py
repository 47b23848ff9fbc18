"""Instance normalization with affine parameters and an optional fused ReLU.

Matches PyTorch ``nn.InstanceNorm2d(C, affine=True)``: per-(sample,
channel) mean and *biased* variance over the spatial dims, eps=1e-5, then
the learned scale and shift. Statistics are always float32.

Tensors are (N, C, H, W), kept in ``torch.channels_last`` memory format by
the model. The affine is (C,), or (N, C) per sample (conditional instance
norm, multi-style training). ``instance_norm`` runs the hand-written kernels
for a CUDA tensor and their plain PyTorch versions for a CPU tensor
(``ops/cuda_norm.py``):
under autograd through ``InstanceNormFn`` (forward kernel, backward kernel),
otherwise (``no_grad``, ``inference_mode``) as one forward call.
"""

from __future__ import annotations

from typing import Tuple

import torch

from fast_neural_style_transfer_tpu_torch.ops.cuda_norm import (
    InstanceNormFn,
    _moments,
    instance_norm_fwd,
)


def instance_norm_stats(
    x: torch.Tensor, method: str = "stable"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 ``(mean, var)`` of an (N, C, H, W) activation, each shaped
    (N, C, 1, 1). ``method``: "stable" (variance around the mean) or
    "onepass" (var = max(E[x^2] - mean^2, 0))."""
    if method not in ("stable", "onepass"):
        raise ValueError(f"unknown instance_norm_stats method {method!r}")
    mean, var = _moments(x.float(), method == "onepass")
    return mean[:, :, None, None], var[:, :, None, None]


def _affine_f32(p: torch.Tensor) -> torch.Tensor:
    """(C,) or (N, C) affine -> float32, broadcastable against (N, C, H, W)."""
    return p.float()[..., None, None]


def apply_instance_norm_stats(x, mean, var, gamma, beta, *,
                              eps: float = 1e-5, relu: bool = False):
    """Normalize ``x`` with supplied moments (broadcastable against
    (N, C, H, W)) and the learned (C,) or (N, C) affine; output in x's
    dtype. With ``instance_norm_stats(x)`` this composes to
    ``instance_norm(x, ...)``."""
    xf = x.float()
    inv = torch.rsqrt(var.float() + eps)
    out = (xf - mean.float()) * inv
    out = out * _affine_f32(gamma) + _affine_f32(beta)
    if relu:
        out = torch.relu(out)
    return out.to(x.dtype)


def instance_norm(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    *,
    eps: float = 1e-5,
    relu: bool = False,
    onepass: bool = False,
) -> torch.Tensor:
    """Instance norm + affine (+ReLU); differentiable in x, gamma and beta.
    Statistics are "stable" (the JAX package's ``method="auto"``) or, with
    ``onepass``, var = max(E[x^2] - mean^2, 0) (``method="onepass"``)."""
    if torch.is_grad_enabled() and (
            x.requires_grad or gamma.requires_grad or beta.requires_grad):
        return InstanceNormFn.apply(x, gamma, beta, eps, relu, onepass)
    y, _, _ = instance_norm_fwd(x, gamma, beta, eps=eps, relu=relu,
                                onepass=onepass)
    return y
