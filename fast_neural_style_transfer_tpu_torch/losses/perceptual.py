"""Perceptual losses with the reference's reductions (the JAX package's
``losses/perceptual.py``).

- style: per layer, the sum of squared differences between the batch Grams
  and the style image's Gram, times ``layer_weight / c^2``; in a
  multi-style run each target is an (S, c, c) bank and each example's
  target is its row of ``style_select`` (B, S) times the bank;
- content: the sum of squared differences at one tap over c*h*w (not over
  the batch);
- TV: anisotropic squared differences, summed, over b*c*h*w.

``batch_mask`` ((B,) 0/1 floats) zeroes padding examples out of every sum,
and TV's batch count uses the real examples only, so a padded batch gives
the real batch's loss exactly. Features are NHWC; every sum is float32.

Under data parallelism each rank holds a slice of the batch. Style and
content are sums over the batch, so each rank's terms are its shares of
the global ones; TV's mean is not, so a rank passes the global batch
count (``batch_count``) and its TV is its share of the global TV. The
ranks' gradients of these shares then sum to the global loss's
(``train/step.py``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from fast_neural_style_transfer_tpu_torch.ops.gram import gram_matrix


@dataclasses.dataclass(frozen=True)
class LossTaps:
    """Which VGG19 activations feed each loss, validated at construction.
    The defaults are the reference's effective style taps and weights and
    its documented content tap ``relu4_2`` (``REFERENCE_TAPS`` uses the
    ``relu4_3`` its code actually read)."""

    style_taps: Tuple[str, ...] = ("relu1_2", "relu2_2", "relu3_3")
    style_weights: Tuple[float, ...] = (0.25, 0.3, 0.45)
    content_tap: str = "relu4_2"

    def __post_init__(self):
        if len(self.style_taps) != len(self.style_weights):
            raise ValueError(
                f"{len(self.style_taps)} style taps but "
                f"{len(self.style_weights)} weights (the reference silently "
                "zip-truncated this mismatch; we refuse it)")

    @property
    def all_taps(self) -> Tuple[str, ...]:
        """Deduplicated tap list: style taps, then the content tap."""
        seen = list(self.style_taps)
        if self.content_tap not in seen:
            seen.append(self.content_tap)
        return tuple(seen)

    def split(self, feats: Sequence[torch.Tensor]):
        """A feature list ordered as ``all_taps`` -> (style list, content)."""
        by_name = dict(zip(self.all_taps, feats))
        return [by_name[t] for t in self.style_taps], by_name[self.content_tap]


REFERENCE_TAPS = LossTaps(content_tap="relu4_3")


def style_targets_from_features(style_feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Per-layer (c, c) Grams of a batch-1 style image's features."""
    return [gram_matrix(f)[0] for f in style_feats]


def _mask(batch_mask: torch.Tensor, ndim: int) -> torch.Tensor:
    return batch_mask.float().reshape((-1,) + (1,) * (ndim - 1))


def style_loss(
    style_feats: Sequence[torch.Tensor],
    target_grams: Sequence[torch.Tensor],
    weights: Sequence[float],
    style_select: Optional[torch.Tensor] = None,
    batch_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sum over layers of ``w * sum((G - G_target)^2) / c^2``: one (c, c)
    target broadcast over the batch, or (S, c, c) banks with
    ``style_select`` (B, S) picking (or blending) each example's target."""
    if not (len(style_feats) == len(target_grams) == len(weights)):
        raise ValueError("style taps / targets / weights length mismatch")
    multi = target_grams[0].dim() == 3
    if multi and style_select is None:
        raise ValueError("(S, c, c) style-target banks need style_select")
    if style_select is not None and not multi:
        raise ValueError(
            "style_select given but target_grams are single-style (c, c); "
            "stack per-style targets into (S, c, c) banks")
    total = None
    for feat, tgt, w in zip(style_feats, target_grams, weights):
        c = tgt.shape[-1]
        if multi:  # (b, s) @ (s, c, c) -> each example's (c, c) target
            tgt = torch.einsum("bs,sij->bij", style_select.float(), tgt.float())
        else:
            tgt = tgt.float()[None]
        sq = torch.square(gram_matrix(feat) - tgt)
        if batch_mask is not None:
            sq = sq * _mask(batch_mask, 3)
        term = (w * torch.sum(sq)) / (c * c)
        total = term if total is None else total + term
    return total


def content_loss(
    input_feat: torch.Tensor,
    target_feat: torch.Tensor,
    batch_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sum of squared differences over c*h*w (NHWC input)."""
    b, h, w, c = input_feat.shape
    sq = torch.square(input_feat.float() - target_feat.float())
    if batch_mask is not None:
        sq = sq * _mask(batch_mask, 4)
    return torch.sum(sq) / (c * h * w)


def total_variation_loss(
    img: torch.Tensor, batch_mask: Optional[torch.Tensor] = None,
    batch_count=None,
) -> torch.Tensor:
    """Anisotropic TV over b*c*h*w (NHWC input); with ``batch_mask`` the
    count is the real examples'. ``batch_count`` (a number or a 0-dim
    tensor) replaces that count: the global batch's, for a rank's share
    of a data-parallel batch's TV."""
    x = img.float()
    b, h, w, c = x.shape
    sq_h = torch.square(x[:, 1:, :, :] - x[:, :-1, :, :])
    sq_w = torch.square(x[:, :, 1:, :] - x[:, :, :-1, :])
    if batch_mask is not None:
        m = _mask(batch_mask, 4)
        sq_h = sq_h * m
        sq_w = sq_w * m
    if batch_count is None:
        batch_count = torch.sum(batch_mask.float()) if batch_mask is not None else float(b)
    return (torch.sum(sq_h) + torch.sum(sq_w)) / (batch_count * (c * h * w))
