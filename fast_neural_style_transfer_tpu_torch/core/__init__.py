from fast_neural_style_transfer_tpu_torch.core.dtypes import (
    Precision,
    canonical_compute_dtype,
    exact_f32,
)
from fast_neural_style_transfer_tpu_torch.core.shapes import (
    bucket_hw,
    pad_to_multiple_reflect,
    resolve_device,
    round_up_to_multiple,
)

__all__ = [
    "Precision",
    "canonical_compute_dtype",
    "exact_f32",
    "bucket_hw",
    "pad_to_multiple_reflect",
    "resolve_device",
    "round_up_to_multiple",
]
