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

``state_from_reference_checkpoint`` resumes a reference training ``.pth``
(``model_state_dict``, ``optimizer_state_dict``, ``iteration``) fully: the
params, Adam's moments and bias-correction count, the schedule position and
the step.
"""

from __future__ import annotations

import dataclasses
import os
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


def _load_reference(path: str):
    return torch.load(path, map_location="cpu", weights_only=True)


def is_reference_training_checkpoint(path: str) -> bool:
    """True iff ``path`` is a torch-loadable reference training checkpoint
    (it carries ``optimizer_state_dict``), not a bare state_dict ``.pth``,
    an ``.npz`` or a directory."""
    if not (os.path.isfile(path) and path.endswith((".pth", ".pt", ".bin"))):
        return False
    try:
        obj = _load_reference(path)
    except Exception:  # not a torch file, or not one weights_only reads
        return False
    return isinstance(obj, dict) and "optimizer_state_dict" in obj


def state_from_reference_checkpoint(
    path: str,
    net: nn.Module,
    lr: float = 1e-3,
    total_steps: int = 80_000,
    *,
    grad_accum: int = 1,
) -> TrainState:
    """Full resume from a reference training ``.pth`` into ``net`` (a
    single-style ``TransformerNet``, on the device it will train on).

    Restores the params, Adam's ``exp_avg`` / ``exp_avg_sq``, the
    bias-correction count and the cosine schedule's position (``applied``),
    and ``step = iteration * grad_accum`` (the reference's iterations are
    applied updates; it has no accumulation), with no micro-batch in
    flight. Torch Adam's integer state ids index ``model.parameters()``,
    which follows the reference's registration order, as the port's
    ``parameters()`` and ``state_dict()`` do: id i is the i-th key. The
    count is the first param's Adam ``step`` (the JAX package keeps one
    global count), ``iteration`` where it has none; a param with no Adam
    state (never stepped) gets zero moments."""
    obj = _load_reference(path)
    if not (isinstance(obj, dict) and "optimizer_state_dict" in obj):
        raise ValueError(f"{path} is not a reference training checkpoint "
                         "(no optimizer_state_dict)")
    msd = obj["model_state_dict"]
    net.load_state_dict(msd, strict=True)
    iteration = int(obj.get("iteration", 0))
    osd = obj["optimizer_state_dict"]
    ids = list(osd["param_groups"][0]["params"])
    params = list(net.parameters())
    if len(ids) != len(params):
        raise ValueError(f"optimizer has {len(ids)} params but model has "
                         f"{len(params)}")
    found = [osd["state"].get(pid, osd["state"].get(str(pid))) for pid in ids]
    count = int(found[0]["step"]) if found[0] is not None else iteration
    state = create_train_state(net, lr, total_steps, grad_accum=grad_accum,
                               step=iteration * grad_accum)
    opt = state.optimizer
    for p, st in zip(params, found):
        moments = ((torch.zeros_like(p), torch.zeros_like(p)) if st is None else
                   (st["exp_avg"], st["exp_avg_sq"]))
        opt.adam.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": moments[0].to(p.device, torch.float32).reshape(p.shape).clone(),
            "exp_avg_sq": moments[1].to(p.device, torch.float32).reshape(p.shape).clone(),
        }
    opt.applied = count
    return state
