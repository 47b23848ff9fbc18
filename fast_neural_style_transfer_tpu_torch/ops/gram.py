"""Batched Gram matrix for the style loss.

As in the JAX package (and the reference), no normalization inside: the
style loss divides by c^2. Features come NHWC; G[b, c, d] = sum_{h,w}
F[b,h,w,c] F[b,h,w,d] is one batched matmul. The features are cast to
float32 first: a bfloat16 ``bmm`` would round its output to bfloat16, and
Gram entries are sums over h*w products.
"""

from __future__ import annotations

import torch


def gram_matrix(feat: torch.Tensor) -> torch.Tensor:
    """(b, h, w, c) -> (b, c, c) unnormalized Gram in float32."""
    b, h, w, c = feat.shape
    f = feat.float().reshape(b, h * w, c)
    return torch.bmm(f.transpose(1, 2), f)
