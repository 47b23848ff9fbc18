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

``instance_norm_stats`` and ``apply_instance_norm_stats`` split the op in
two, as the JAX package's do (capture one input's moments, normalize
another with them: video's frozen statistics, ``models/transformer.py``).
On a CUDA tensor they run the forward kernel's capture and inject modes
(``ops/cuda_norm.py``), on the CPU those modes' plain versions; on either
device capture then apply gives the plain forward's bits.
"""

from __future__ import annotations

from typing import Tuple

import torch

from fast_neural_style_transfer_tpu_torch.ops.cuda_norm import (
    InstanceNormFn,
    _moments,
    instance_norm_apply_stats,
    instance_norm_fwd,
)


def instance_norm_stats(
    x: torch.Tensor, method: str = "stable"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 ``(mean, var)`` of an (N, C, H, W) activation, each shaped
    (N, C, 1, 1). ``method``: "stable" (variance around the mean) or
    "onepass" (var = max(E[x^2] - mean^2, 0)). On a CUDA tensor: one launch
    of the forward kernel's capture mode, whose y is dropped."""
    if method not in ("stable", "onepass"):
        raise ValueError(f"unknown instance_norm_stats method {method!r}")
    if x.device.type == "cuda":
        c = x.shape[1]
        ones = torch.ones(c, device=x.device)
        _, mean, _, var = instance_norm_fwd(
            x.contiguous(memory_format=torch.channels_last), ones,
            torch.zeros_like(ones), onepass=method == "onepass", capture=True)
    else:
        mean, var = _moments(x.float(), method == "onepass")
    return mean[:, :, None, None], var[:, :, None, None]


def apply_instance_norm_stats(x, mean, var, gamma, beta, *,
                              eps: float = 1e-5, relu: bool = False,
                              blend: float = 1.0):
    """Normalize ``x`` with supplied moments and the learned (C,) or (N, C)
    affine; output in x's dtype. ``mean``, ``var``: (1, C) or (N, C) rows,
    or shapes that flatten to them, such as ``instance_norm_stats``'
    (N, C, 1, 1). ``blend`` < 1 normalizes with ``blend * supplied + (1 -
    blend) * x's own`` (stable) moments. The inject mode
    (``instance_norm_apply_stats``): its kernel on a CUDA tensor, its plain
    version on the CPU, both with the forward's arithmetic (y = x * scale +
    shift), so at blend 1 with ``instance_norm_stats(x)`` this gives
    ``instance_norm(x, ...)``'s bits; the JAX package's formula,
    ``(x - mean) * inv * gamma + beta``, agrees to f32 rounding."""
    return instance_norm_apply_stats(
        x.contiguous(memory_format=torch.channels_last), gamma, beta, mean, var,
        blend=blend, relu=relu, eps=eps)[0]


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
