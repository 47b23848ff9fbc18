"""Stylizer weights: the reference ``.pth`` and the JAX package's params.

The port's ``TransformerNet`` holds its weights in the reference
``StyleTransferNet`` state_dict layout, so a reference ``.pth`` (bare, or
under ``model_state_dict``) loads as it is. The JAX package keeps a nested
tree (``conv1: {w, b}``, ``norm1: {gamma, beta}``, ``res_blocks: [{conv1,
in1, conv2, in2}, ...]``) with HWIO conv weights; ``params_from_jax`` maps
that tree of numpy arrays onto the state_dict:

    HWIO -> OIHW  for Conv2d          (conv1, conv2, res convs, final_conv)
    HWIO -> IOHW  for ConvTranspose2d (up1, up2)
    gamma/beta -> weight/bias         (norm1..4, res in1/in2; (C,), or an
                                       (S, C) bank in a multi-style net)

Its ``.npz`` files store the same tree flat, under keys such as
``res_blocks/0/conv1/w``; ``save_params_npz`` writes a state_dict in that
layout (the training loop's final artifact), which this module's
``load_checkpoint`` and the JAX package's ``Stylizer.load_params`` both read.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

from fast_neural_style_transfer_tpu_torch.models.transformer import NUM_RES_BLOCKS

StateDict = Dict[str, torch.Tensor]

# (JAX tree path, state_dict key prefix, is_transpose)
_CONV_MAP: List[Tuple[Tuple, str, bool]] = [
    (("conv1",), "conv1.conv", False),
    (("conv2",), "conv2.conv", False),
    (("up1",), "up1.upsample_conv", True),
    (("up2",), "up2.upsample_conv", True),
    (("final_conv",), "final_conv.conv", False),
] + [
    (("res_blocks", i, c), f"res_blocks.{i}.{c}.conv", False)
    for i in range(NUM_RES_BLOCKS)
    for c in ("conv1", "conv2")
]

_NORM_MAP: List[Tuple[Tuple, str]] = [
    ((n,), n) for n in ("norm1", "norm2", "norm3", "norm4")
] + [
    (("res_blocks", i, n), f"res_blocks.{i}.{n}")
    for i in range(NUM_RES_BLOCKS)
    for n in ("in1", "in2")
]


def _get(tree: Any, path) -> Any:
    for k in path:
        tree = tree[k]
    return tree


def params_from_jax(tree: Mapping[str, Any]) -> StateDict:
    """JAX-package params (a tree of numpy arrays) -> reference state_dict
    of float32 CPU tensors, multi-style (S, C) banks as they are."""
    sd: StateDict = {}
    for path, prefix, transpose in _CONV_MAP:
        node = _get(tree, path)
        w = np.asarray(node["w"], np.float32)  # HWIO
        perm = (2, 3, 0, 1) if transpose else (3, 2, 0, 1)
        sd[prefix + ".weight"] = torch.from_numpy(np.ascontiguousarray(w.transpose(perm)))
        sd[prefix + ".bias"] = torch.from_numpy(np.array(node["b"], np.float32))
    for path, prefix in _NORM_MAP:
        node = _get(tree, path)
        sd[prefix + ".weight"] = torch.from_numpy(np.array(node["gamma"], np.float32))
        sd[prefix + ".bias"] = torch.from_numpy(np.array(node["beta"], np.float32))
    return sd


def save_params_npz(state_dict: Mapping[str, torch.Tensor], path: str) -> None:
    """Reference-layout state_dict -> the JAX package's flat ``.npz``
    (``train/checkpoint.py::save_params_npz`` keys): OIHW -> HWIO for
    Conv2d, IOHW -> HWIO for ConvTranspose2d, weight/bias -> gamma/beta."""
    def arr(key):
        return state_dict[key].detach().cpu().float().numpy()

    flat: Dict[str, np.ndarray] = {}
    for path_, prefix, transpose in _CONV_MAP:
        key = "/".join(str(k) for k in path_)
        perm = (2, 3, 0, 1) if transpose else (2, 3, 1, 0)
        flat[f"{key}/w"] = np.ascontiguousarray(arr(prefix + ".weight").transpose(perm))
        flat[f"{key}/b"] = arr(prefix + ".bias")
    for path_, prefix in _NORM_MAP:
        key = "/".join(str(k) for k in path_)
        flat[f"{key}/gamma"] = arr(prefix + ".weight")
        flat[f"{key}/beta"] = arr(prefix + ".bias")
    np.savez(path, **flat)


def _tree_from_npz(path: str) -> Dict[str, Any]:
    """Read a JAX-package ``.npz`` (flat ``a/b/c`` keys) into a nested tree
    with ``res_blocks`` as a list."""
    tree: Dict[str, Any] = {"res_blocks": [{} for _ in range(NUM_RES_BLOCKS)]}
    with np.load(path) as z:
        for key in z.files:
            parts = key.split("/")
            node: Any = tree
            if parts[0] == "res_blocks":
                node = tree["res_blocks"][int(parts[1])]
                parts = parts[2:]
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = np.asarray(z[key])
    return tree


def load_checkpoint(path: str) -> StateDict:
    """Load stylizer weights as a reference-layout state_dict.

    ``.pth``/``.bin``: a reference state_dict, bare or under
    ``model_state_dict``, read with ``torch.load(weights_only=True)``.
    ``.npz``: the JAX package's flat params file. Orbax checkpoint
    directories are not ported (they need orbax)."""
    if path.endswith(".npz"):
        return params_from_jax(_tree_from_npz(path))
    if path.endswith(".pt"):
        raise ValueError(
            "TorchScript .pt archives bake weights into the traced graph "
            "and cannot be imported; load the matching .pth/.npz instead")
    if path.endswith((".pth", ".bin")):
        obj = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(obj, dict) and "model_state_dict" in obj:
            obj = obj["model_state_dict"]
        if not isinstance(obj, Mapping) or "norm1.weight" not in obj:
            raise ValueError(f"{path} holds no stylizer state_dict")
        return {k: v.detach().to(torch.float32) for k, v in obj.items()}
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is an Orbax checkpoint directory; Orbax loading is not "
            "yet ported (export the params to .npz or .pth)")
    raise FileNotFoundError(
        f"no such checkpoint: {path} (expected a .npz or .pth file)")
