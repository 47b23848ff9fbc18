"""Loss-curve plots from the training loop's ``metrics.jsonl`` (the JAX
package's ``utils/visualization.py``).

One PNG per curve, named ``<curve>.png``: ``loss.png``, ``content_loss.png``,
``style_loss.png``, ``tv_loss.png`` by default. Plotting needs matplotlib;
reading the metrics does not.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

DEFAULT_CURVES = ("loss", "content_loss", "style_loss", "tv_loss")


def read_metrics(jsonl_path: str) -> List[Dict]:
    """The records of a metrics file, one per step, in step order.

    The file is appended to across resumes, so a line that does not parse
    (the torn last line of a preempted writer) is skipped, and where a
    resume from an earlier checkpoint logged a step again the last record
    of that step is kept."""
    by_step: Dict = {}
    order = 0
    with open(jsonl_path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            by_step[rec.get("step", order)] = rec
            order += 1
    return [by_step[s] for s in sorted(by_step)]


def plot_loss_curves(
    jsonl_path: str,
    output_dir: Optional[str] = None,
    curves: Sequence[str] = DEFAULT_CURVES,
    *,
    log_scale: bool = True,
) -> List[str]:
    """Write ``<curve>.png`` for each curve every record has (into the
    metrics file's directory by default); returns the written paths. A log
    y axis where ``log_scale`` and every value is positive."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    records = read_metrics(jsonl_path)
    if not records:
        raise ValueError(f"no metric records in {jsonl_path}")
    output_dir = output_dir or os.path.dirname(jsonl_path) or "."
    os.makedirs(output_dir, exist_ok=True)
    steps = [r["step"] for r in records]

    written = []
    for curve in curves:
        values = [r.get(curve) for r in records]
        if any(v is None for v in values):
            continue
        fig, ax = plt.subplots(figsize=(7, 4))
        ax.plot(steps, values, linewidth=1.2)
        ax.set_xlabel("step")
        ax.set_ylabel(curve)
        if log_scale and min(values) > 0:
            ax.set_yscale("log")
        ax.set_title(curve.replace("_", " "))
        ax.grid(True, alpha=0.3)
        path = os.path.join(output_dir, f"{curve}.png")
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        written.append(path)
    return written


def plot_after_training(output_dir: str, curves: Sequence[str] = DEFAULT_CURVES) -> None:
    """The trainers' last act: plot ``<output_dir>/metrics.jsonl`` into
    ``output_dir``. Plotting never fails a training run: any error (no
    matplotlib, no records) prints ``loss-curve plotting skipped: ...``."""
    try:
        plot_loss_curves(os.path.join(output_dir, "metrics.jsonl"), output_dir,
                         curves=curves)
    except Exception as e:
        print(f"loss-curve plotting skipped: {e}", flush=True)
