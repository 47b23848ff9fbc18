"""Stylizer checkpoints in the reference's ``.pth`` layout (the JAX
package's ``export/torch_convert.py``).

The port's ``TransformerNet`` already holds its weights in the reference
``StyleTransferNet`` state_dict layout (``models/weights.py``), so where the
JAX package transposes HWIO trees to OIHW / IOHW, this module only orders,
copies and saves:

- ``to_torch_state_dict``: a single-style net or state_dict -> float32 numpy
  arrays in the reference's registration order;
- ``save_torch_checkpoint`` / ``load_torch_checkpoint``: the inference
  ``.pth`` (``{"model_state_dict": ...}``, which the reference's
  ``inference.py`` loads) and back;
- ``save_torch_training_checkpoint``: a full reference training ``.pth``
  (params, Adam moments, schedule position) from a port ``TrainState``,
  which ``train/state.py::state_from_reference_checkpoint`` resumes exactly.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn

from fast_neural_style_transfer_tpu_torch.models.transformer import (
    NUM_RES_BLOCKS,
    require_single_style,
)
from fast_neural_style_transfer_tpu_torch.models.weights import load_checkpoint

# Torch key prefixes in the reference's module registration order (conv1,
# norm1, conv2, norm2, res_blocks.{i}.(conv1, in1, conv2, in2), up1, norm3,
# up2, norm4, final_conv): torch Adam's integer state ids index
# ``model.parameters()``, which follows that order.
_TORCH_PREFIX_ORDER: List[str] = (
    ["conv1.conv", "norm1", "conv2.conv", "norm2"]
    + [f"res_blocks.{i}.{m}" for i in range(NUM_RES_BLOCKS)
       for m in ("conv1.conv", "in1", "conv2.conv", "in2")]
    + ["up1.upsample_conv", "norm3", "up2.upsample_conv", "norm4",
       "final_conv.conv"]
)
TORCH_KEYS: List[str] = [p + leaf for p in _TORCH_PREFIX_ORDER
                         for leaf in (".weight", ".bias")]


def to_torch_state_dict(
        params: Union[nn.Module, Mapping[str, torch.Tensor]]) -> Dict[str, np.ndarray]:
    """A single-style ``TransformerNet`` or its state_dict -> the reference
    state_dict as float32 numpy arrays (owning copies), keys in the
    reference's registration order."""
    sd = params.state_dict() if isinstance(params, nn.Module) else params
    require_single_style(sd, "to_torch_state_dict")
    missing = sorted(set(TORCH_KEYS) - set(sd))
    extra = sorted(set(sd) - set(TORCH_KEYS))
    if missing or extra:
        raise ValueError(f"not a stylizer state_dict: missing {missing}, "
                         f"unexpected {extra}")
    return {k: np.array(sd[k].detach().cpu().float().numpy(), copy=True)
            for k in TORCH_KEYS}


def _tensors(arrays: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in arrays.items()}


def save_torch_checkpoint(params, path: str) -> None:
    """Write the ``.pth`` the reference's ``inference.py`` loads: the
    state_dict under ``model_state_dict``."""
    torch.save({"model_state_dict": _tensors(to_torch_state_dict(params))}, path)


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A reference ``.pth`` (bare, or under ``model_state_dict``) -> the
    port's state_dict (``models/weights.py::load_checkpoint``)."""
    return load_checkpoint(path)


def save_torch_training_checkpoint(
    state,
    path: str,
    *,
    lr: float = 1e-3,
    weight_decay: float = 1e-5,
    loss: float = 0.0,
    weights: Optional[Dict[str, float]] = None,
) -> None:
    """Write a full reference training checkpoint (the dict the reference
    trainer saves every 5000 iterations and resumes from) from a port
    ``train/state.py::TrainState`` of a single-style net: ``model_state_dict``,
    ``optimizer_state_dict`` (Adam's ``exp_avg`` / ``exp_avg_sq`` under the
    integer ids of ``model.parameters()``, ``step`` the updates applied),
    ``scheduler_state_dict`` and ``iteration``, the updates applied
    (``state.step // grad_accum``). A micro-batch still being accumulated is
    not part of the format and is dropped. ``lr``, ``weight_decay``: the
    hyperparameters written into the param group (torch Adam's
    ``load_state_dict`` installs the group as it is)."""
    msd = _tensors(to_torch_state_dict(state.net))
    opt = state.optimizer
    count = float(opt.applied)
    iteration = int(state.step) // opt.grad_accum
    adam_state = {}
    by_param = dict(state.net.named_parameters())
    for i, key in enumerate(msd):
        st = opt.adam.state.get(by_param[key], {})
        zeros = torch.zeros_like(msd[key])
        adam_state[i] = {
            "step": torch.tensor(count),
            "exp_avg": st["exp_avg"].detach().cpu().float().clone() if st else zeros,
            "exp_avg_sq": st["exp_avg_sq"].detach().cpu().float().clone() if st else zeros,
        }
    group = {
        "lr": lr,
        "betas": (0.9, 0.999),
        "eps": 1e-8,
        "weight_decay": weight_decay,
        "amsgrad": False,
        "maximize": False,
        "foreach": None,
        "capturable": False,
        "differentiable": False,
        "fused": None,
        "params": list(range(len(msd))),
    }
    w = weights or {}
    torch.save({
        "model_state_dict": msd,
        "optimizer_state_dict": {"state": adam_state, "param_groups": [group]},
        "scheduler_state_dict": {"last_epoch": iteration, "_step_count": iteration + 1},
        "iteration": iteration,
        "loss": loss,
        "content_weight": w.get("content", 1000.0),
        "style_weight": w.get("style", 1.0),
        "tv_weight": w.get("tv", 10.0),
    }, path)

