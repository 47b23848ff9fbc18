"""Learning-rate and loss-weight schedules, closed forms of the step (the
JAX package's ``train/schedule.py``), evaluated in float32 as there.

The LR is torch's ``CosineAnnealingLR(T_max=total_steps, eta_min)`` stepped
once per applied update; the loss weights halve content and double style
every ``decay_every`` applied updates, TV constant.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Tuple

import numpy as np


def cosine_lr_schedule(base_lr: float, total_steps: int,
                       eta_min: float = 1e-7) -> Callable[[int], float]:
    """step -> LR, the closed form of CosineAnnealingLR per iteration."""
    f32 = np.float32

    def schedule(step: int) -> float:
        t = f32(min(int(step), total_steps))
        cos = f32(np.cos(f32(math.pi) * t / f32(total_steps)))
        return float(f32(eta_min) + (f32(base_lr) - f32(eta_min))
                     * (f32(1.0) + cos) / f32(2.0))

    return schedule


@dataclasses.dataclass(frozen=True)
class LossWeightSchedule:
    """Step-dependent (content, style, tv) weights; ``decay_every=0``
    keeps them constant."""

    content: float = 1000.0
    style: float = 1.0
    tv: float = 10.0
    decay_every: int = 10_000

    def __call__(self, step: int) -> Tuple[float, float, float]:
        k = 0 if self.decay_every <= 0 else int(step) // self.decay_every
        f32 = np.float32
        return (float(f32(self.content) * f32(0.5) ** k),
                float(f32(self.style) * f32(2.0) ** k),
                float(f32(self.tv)))
