from fast_neural_style_transfer_tpu_torch.losses.perceptual import (
    REFERENCE_TAPS,
    LossTaps,
    content_loss,
    style_loss,
    style_targets_from_features,
    total_variation_loss,
)

__all__ = [
    "REFERENCE_TAPS",
    "LossTaps",
    "content_loss",
    "style_loss",
    "style_targets_from_features",
    "total_variation_loss",
]
