"""Structured metric logging (the JAX package's ``utils/logging.py``):
running means every ``print_every`` steps, printed and appended to a JSONL
file. Step metrics stay device tensors until a flush, which fetches all of
them in one copy."""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

import torch


class MetricLogger:
    def __init__(self, jsonl_path: Optional[str] = None, print_every: int = 100):
        self.jsonl_path = jsonl_path
        self.print_every = print_every
        self._pending: list = []
        self._t0 = time.perf_counter()
        self._fh = None
        if jsonl_path:
            os.makedirs(os.path.dirname(jsonl_path) or ".", exist_ok=True)
            self._fh = open(jsonl_path, "a", buffering=1)

    def update(self, metrics: Dict[str, Any]) -> None:
        self._pending.append(metrics)

    @property
    def pending(self) -> int:
        return len(self._pending)

    def should_log(self, step: int) -> bool:
        return step % self.print_every == 0 and bool(self._pending)

    def flush(self, step: int) -> Dict[str, Any]:
        """Emit the means since the last flush and reset."""
        keys = sorted({k for m in self._pending for k in m})
        rows = [[torch.as_tensor(m.get(k, float("nan"))) for k in keys]
                for m in self._pending]
        dev = next((v.device for row in rows for v in row if v.device.type != "cpu"),
                   torch.device("cpu"))
        count = len(rows)
        means = {}
        if rows:
            stacked = torch.stack([torch.stack([v.to(dev, torch.float32) for v in row])
                                   for row in rows]).cpu()  # the one device->host copy
            means = {k: float(v) for k, v in zip(keys, stacked.mean(dim=0))}
        now = time.perf_counter()
        record = {"step": step, "steps_per_sec": count / max(now - self._t0, 1e-9),
                  **means}
        if self._fh:
            self._fh.write(json.dumps(record) + "\n")
        parts = [f"step {step}"]
        for k, v in record.items():
            if k != "step" and isinstance(v, float):
                parts.append(f"{k}={v:.6g}")
        print("  ".join(parts), flush=True)
        self._pending.clear()
        self._t0 = now
        return record

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
