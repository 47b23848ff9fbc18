"""Precision policy.

Params are always stored in float32. Compute runs in float32 or bfloat16;
convolutions accumulate in float32 inside cuDNN either way, and
instance-norm statistics are always float32. int8 is not a compute dtype
here: ``Stylizer(precision="int8")`` quantizes the convs
(``infer/quantized.py``) and runs the rest in float32. On the card
``exact_f32`` makes float32 mean float32 (TF32 off), for every entry point.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Precision:
    """Precision policy threaded through the model forward.

    Attributes:
        compute_dtype: dtype activations and weights are cast to for convs.
    """

    compute_dtype: torch.dtype = torch.float32

    @staticmethod
    def f32() -> "Precision":
        return Precision()

    @staticmethod
    def bf16() -> "Precision":
        return Precision(compute_dtype=torch.bfloat16)


def canonical_compute_dtype(name: str) -> Precision:
    name = name.lower()
    if name in ("f32", "float32", "fp32"):
        return Precision.f32()
    if name in ("bf16", "bfloat16"):
        return Precision.bf16()
    raise ValueError(f"unknown precision {name!r}; expected 'f32' or 'bf16'")


def exact_f32(device: torch.device, precision: Precision) -> None:
    """Turn TF32 off on the card when the compute dtype is float32."""
    if device.type == "cuda" and precision.compute_dtype == torch.float32:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
