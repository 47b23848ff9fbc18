"""Preemption-safe training checkpoints (the JAX package's
``train/checkpoint.py``, without Orbax).

A checkpoint is one ``torch.save`` file of the ``TrainState``: the
stylizer's state_dict, the optimizer's state (Adam moments, the applied
count, any partly accumulated gradients) and the micro-step, under
``<dir>/ckpt_<label>.pt``. It is written to a temporary name and renamed
into place, then the ``latest`` pointer file is rewritten the same way, so
a crash at any point leaves the previous checkpoint restorable. Only the
newest ``max_to_keep`` files are kept. The label is the loop's step counter
(it also counts skipped non-finite steps, which the state's step does not).

Orbax checkpoint directories, which the JAX package writes, are not read
(not yet ported: export the params to .npz instead).
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional

import torch

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")
_LATEST = "latest"


def _atomic_write(path: str, write) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


class CheckpointManager:
    def __init__(self, directory: str, *, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        if any(d.isdigit() and os.path.isdir(os.path.join(self.directory, d))
               for d in os.listdir(self.directory)):
            raise NotImplementedError(
                f"{self.directory} holds Orbax checkpoint steps; Orbax loading "
                "is not yet ported (export the params to .npz)")
        self.max_to_keep = max_to_keep

    def _path(self, label: int) -> str:
        return os.path.join(self.directory, f"ckpt_{label:08d}.pt")

    def labels(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory))
                      if m)

    def latest_step(self) -> Optional[int]:
        pointer = os.path.join(self.directory, _LATEST)
        if not os.path.exists(pointer):
            return None
        with open(pointer) as f:
            label = int(f.read().strip())
        return label if os.path.exists(self._path(label)) else None

    def save(self, label: int, state_dict: Dict[str, Any]) -> str:
        path = self._path(label)
        _atomic_write(path, lambda tmp: torch.save(state_dict, tmp))

        def write_pointer(tmp):
            with open(tmp, "w") as f:
                f.write(f"{label}\n")

        _atomic_write(os.path.join(self.directory, _LATEST), write_pointer)
        for old in self.labels()[:-self.max_to_keep]:
            os.remove(self._path(old))
        return path

    def restore(self, label: Optional[int] = None) -> Dict[str, Any]:
        label = self.latest_step() if label is None else label
        if label is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        return torch.load(self._path(label), map_location="cpu", weights_only=True)
