"""Training state and the reference's optimizer (the JAX package's
``train/state.py``).

The JAX package's optax chain, in order: global-norm clip 1.0 (optax's
form: ``g / ||g|| * 1.0`` when ``||g|| >= 1``, else ``g``), L2 weight decay
1e-5 added to the clipped gradient, Adam(0.9, 0.999, eps 1e-8), then the
closed-form cosine LR over ``total_steps // grad_accum`` applied updates
(``eta_min`` 1e-7). Here: the clip is written out in optax's form, and
``torch.optim.Adam(weight_decay=1e-5)`` does the decay (it adds
``wd * param`` to the gradient it is handed, the clipped one) and Adam; its
LR is set before each update from the cosine's closed form at the count of
updates applied so far, which is optax's schedule count. With ``grad_accum
= k`` the gradients of k micro-batches are averaged first, as
``optax.MultiSteps`` does (running mean ``acc + (g - acc) / (i + 1)``), and
one update is made on the k-th.

The reference training ``.pth`` full resume (``state_from_reference_checkpoint``)
is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import torch
from torch import nn

from fast_neural_style_transfer_tpu_torch.train.schedule import cosine_lr_schedule


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in tensors))


class StyleOptimizer:
    """clip -> weight decay -> Adam -> cosine LR, with gradient averaging
    over ``grad_accum`` micro-batches."""

    def __init__(
        self,
        params: Sequence[nn.Parameter],
        lr: float = 1e-3,
        total_steps: int = 80_000,
        *,
        weight_decay: float = 1e-5,
        clip_norm: float = 1.0,
        eta_min: float = 1e-7,
        grad_accum: int = 1,
    ):
        if grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
        self.params: List[nn.Parameter] = list(params)
        self.adam = torch.optim.Adam(self.params, lr=lr, betas=(0.9, 0.999),
                                     eps=1e-8, weight_decay=weight_decay)
        self.schedule = cosine_lr_schedule(lr, max(total_steps // grad_accum, 1),
                                           eta_min)
        self.clip_norm = clip_norm
        self.grad_accum = grad_accum
        self.mini_step = 0  # micro-batches accumulated toward the next update
        self.applied = 0  # updates applied (the schedule's count)
        self.acc: Optional[List[torch.Tensor]] = None

    def update(self, grads: Sequence[torch.Tensor]) -> bool:
        """Take one micro-batch's gradients (aligned with ``params``); make
        an update on the ``grad_accum``-th. Returns whether params moved."""
        grads = list(grads)
        if self.grad_accum > 1:
            if self.acc is None:
                self.acc = [torch.zeros_like(g) for g in grads]
            n = self.mini_step
            self.acc = [a + (g - a) / (n + 1) for a, g in zip(self.acc, grads)]
            self.mini_step += 1
            if self.mini_step < self.grad_accum:
                return False
            grads, self.acc, self.mini_step = self.acc, None, 0
        norm = global_norm(grads)
        clip = self.clip_norm
        for p, g in zip(self.params, grads):
            p.grad = torch.where(norm < clip, g, g / norm * clip)
        lr = self.schedule(self.applied)
        for group in self.adam.param_groups:
            group["lr"] = lr
        self.adam.step()
        self.adam.zero_grad(set_to_none=True)
        self.applied += 1
        return True

    def state_dict(self) -> Dict[str, Any]:
        return {"adam": self.adam.state_dict(), "mini_step": self.mini_step,
                "applied": self.applied, "acc": self.acc}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.adam.load_state_dict(sd["adam"])
        self.mini_step = int(sd["mini_step"])
        self.applied = int(sd["applied"])
        self.acc = None if sd["acc"] is None else [
            a.to(p.device) for a, p in zip(sd["acc"], self.params)]


@dataclasses.dataclass
class TrainState:
    """The stylizer, its optimizer and the micro-step counter (advanced
    only by steps whose loss was finite)."""

    net: nn.Module
    optimizer: StyleOptimizer
    step: int = 0

    def state_dict(self) -> Dict[str, Any]:
        return {"params": {k: v.detach().cpu() for k, v in self.net.state_dict().items()},
                "optimizer": self.optimizer.state_dict(), "step": self.step}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.net.load_state_dict(sd["params"], strict=True)
        self.optimizer.load_state_dict(sd["optimizer"])
        self.step = int(sd["step"])


def create_train_state(
    net: nn.Module,
    lr: float = 1e-3,
    total_steps: int = 80_000,
    *,
    grad_accum: int = 1,
    step: int = 0,
) -> TrainState:
    """A TrainState whose optimizer holds ``net``'s parameters."""
    opt = StyleOptimizer(net.parameters(), lr, total_steps, grad_accum=grad_accum)
    return TrainState(net=net, optimizer=opt, step=step)
