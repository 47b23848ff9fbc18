"""VGG19 weights: files, the JAX package's params, and the seeded fallback.

No ImageNet weights can be downloaded here, so they come from a file:

- ``.npz``: the JAX package's format, arrays ``<conv>.w`` (HWIO) and
  ``<conv>.b``;
- ``.pth`` / ``.pt`` / ``.bin``: a torchvision ``vgg19().state_dict()`` or
  ``vgg19().features.state_dict()`` (keys ``features.<i>.weight`` or
  ``<i>.weight``, OIHW), through ``TORCHVISION_CONV_INDEX``.

``save_npz`` and ``to_torch_state_dict`` write those two layouts back, so a
VGG converted once reads in both packages.

``resolve_params(None, seed)`` (and no ``FNST_VGG19_WEIGHTS``) warns and
falls back to a deterministic random VGG drawn from an explicit
``torch.Generator``: N(0, 0.05^2) weights and zero biases, as the JAX
package's ``VGG19Features.init``. Its numbers differ from the JAX fallback's
(another generator); ``vgg_params_from_jax`` carries the JAX params across
when both packages must run on the same VGG.
"""

from __future__ import annotations

import os
import warnings
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from fast_neural_style_transfer_tpu_torch.models.vgg import (
    CONV_NAMES,
    TORCHVISION_CONV_INDEX,
    VGG19Features,
    conv_shapes,
)

StateDict = Dict[str, torch.Tensor]


def _from_hwio(name: str, w: Any, b: Any) -> StateDict:
    w = np.asarray(w, np.float32)
    return {f"{name}.weight": torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))),
            f"{name}.bias": torch.from_numpy(np.array(b, np.float32))}


def vgg_params_from_jax(tree: Mapping[str, Any]) -> StateDict:
    """The JAX package's VGG params ``{conv: {"w": HWIO, "b": (C,)}}`` (numpy
    arrays) -> this module's state_dict (OIHW)."""
    sd: StateDict = {}
    for name in CONV_NAMES:
        sd.update(_from_hwio(name, tree[name]["w"], tree[name]["b"]))
    return sd


def load_npz(path: str) -> StateDict:
    sd: StateDict = {}
    with np.load(path) as z:
        for name in CONV_NAMES:
            sd.update(_from_hwio(name, z[f"{name}.w"], z[f"{name}.b"]))
    return sd


def save_npz(state_dict: Mapping[str, Any], path: str) -> None:
    """This module's state_dict -> the JAX package's ``.npz`` (``<conv>.w``
    HWIO, ``<conv>.b``)."""
    flat = {}
    for name in CONV_NAMES:
        w = torch.as_tensor(state_dict[f"{name}.weight"]).detach().float().cpu().numpy()
        flat[f"{name}.w"] = np.ascontiguousarray(w.transpose(2, 3, 1, 0))
        flat[f"{name}.b"] = (torch.as_tensor(state_dict[f"{name}.bias"])
                             .detach().float().cpu().numpy())
    np.savez(path, **flat)


def to_torch_state_dict(state_dict: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """This module's state_dict -> torchvision's ``features`` layout
    (``features.<i>.weight`` OIHW, ``features.<i>.bias``) as numpy arrays,
    the inverse of ``from_torchvision_state_dict``."""
    sd: Dict[str, np.ndarray] = {}
    for name in CONV_NAMES:
        idx = TORCHVISION_CONV_INDEX[name]
        for kind in ("weight", "bias"):
            sd[f"features.{idx}.{kind}"] = (torch.as_tensor(state_dict[f"{name}.{kind}"])
                                            .detach().float().cpu().numpy().copy())
    return sd


def from_torchvision_state_dict(state_dict: Mapping[str, Any]) -> StateDict:
    """A torchvision VGG19 state_dict (OIHW) -> this module's state_dict."""

    def get(idx: int, kind: str) -> torch.Tensor:
        for prefix in (f"features.{idx}.", f"{idx}."):
            if prefix + kind in state_dict:
                return torch.as_tensor(state_dict[prefix + kind]).detach().float().clone()
        raise KeyError(f"VGG19 state_dict missing layer {idx} {kind}")

    sd: StateDict = {}
    for name in CONV_NAMES:
        idx = TORCHVISION_CONV_INDEX[name]
        sd[f"{name}.weight"] = get(idx, "weight")
        sd[f"{name}.bias"] = get(idx, "bias")
    return sd


def load_torch_file(path: str) -> StateDict:
    obj = torch.load(path, map_location="cpu", weights_only=True)
    return from_torchvision_state_dict(obj)


def random_params(seed: int = 0, *, scale: float = 0.05) -> StateDict:
    """Deterministic random VGG (tests, no-weights fallback): weights
    ``scale * N(0, 1)`` from ``torch.Generator().manual_seed(seed)``, in
    forward order, zero biases."""
    gen = torch.Generator().manual_seed(seed)
    sd: StateDict = {}
    for name, cin, cout in conv_shapes():
        sd[f"{name}.weight"] = scale * torch.randn((cout, cin, 3, 3), generator=gen)
        sd[f"{name}.bias"] = torch.zeros(cout)
    return sd


def resolve_params(path: Optional[str], *, seed: int = 0) -> StateDict:
    """Load VGG19 weights from ``path`` (or ``FNST_VGG19_WEIGHTS``); with
    neither, warn and fall back to ``random_params(seed)``."""
    if path:
        if not os.path.exists(path):
            raise FileNotFoundError(f"VGG19 weights file not found: {path}")
        if path.endswith(".npz"):
            return load_npz(path)
        if path.endswith((".pth", ".pt", ".bin")):
            return load_torch_file(path)
        raise ValueError(f"unsupported VGG19 weights format: {path}")
    env_path = os.environ.get("FNST_VGG19_WEIGHTS")
    if env_path and os.path.exists(env_path):
        return resolve_params(env_path)
    warnings.warn(
        "No pretrained VGG19 weights supplied (pass --vgg_weights or set "
        "FNST_VGG19_WEIGHTS). Falling back to deterministic random features: "
        "training will run but stylization quality requires ImageNet weights.",
        stacklevel=2,
    )
    return random_params(seed)


def make_vgg(state_dict: Mapping[str, torch.Tensor], device) -> VGG19Features:
    """A frozen ``VGG19Features`` on ``device``, channels_last, eval mode."""
    vgg = VGG19Features()
    vgg.load_state_dict(state_dict, strict=True)
    return vgg.eval().to(device, memory_format=torch.channels_last)
