"""Preemption drill for the AdaIN decoder trainer (``train/adain.py``), the
JAX package's ``tools/adain_soak.py``: ``phase_a`` trains in a child
process and SIGTERMs it once at half way, ``phase_b`` resumes from the
latest checkpoint to the end, ``report`` verifies the evidence and writes
``<outdir>/report.json``.

    python -m fast_neural_style_transfer_tpu_torch.tools.adain_soak dataset
    python -m fast_neural_style_transfer_tpu_torch.tools.adain_soak phase_a [outdir]
    python -m fast_neural_style_transfer_tpu_torch.tools.adain_soak phase_b [outdir]
    python -m fast_neural_style_transfer_tpu_torch.tools.adain_soak report  [outdir]

Parameters from the environment, pinned to ``<outdir>/soak_config.json``
by the first phase: ``FNST_ADAIN_STEPS`` (1500), ``FNST_ADAIN_BATCH`` (8,
the paper's), ``FNST_ADAIN_CKPT_EVERY`` (200), ``FNST_ADAIN_SIZE`` (256),
``FNST_ADAIN_CONTENT`` and ``FNST_ADAIN_STYLE`` (under the temporary
directory); a row logged every 50 steps, on the card (``run_config``
overrides pin others, as in ``tools/soak.py``). The child runs under
``tools/soak.py::run_phase``'s supervisor (the stall watchdog, SIGTERM
exactly once).
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
from typing import List, Optional

from fast_neural_style_transfer_tpu_torch.tools import soak


def _defaults() -> dict:
    env = os.environ.get
    tmp = tempfile.gettempdir()
    return {
        "total_steps": int(env("FNST_ADAIN_STEPS", 1500)),
        "batch": int(env("FNST_ADAIN_BATCH", 8)),
        "ckpt_every": int(env("FNST_ADAIN_CKPT_EVERY", 200)),
        "image_size": int(env("FNST_ADAIN_SIZE", 256)),
        "log_every": 50,
        "content_dir": env("FNST_ADAIN_CONTENT", os.path.join(tmp, "fnst_adain_content")),
        "style_dir": env("FNST_ADAIN_STYLE", os.path.join(tmp, "fnst_adain_style")),
        "device": None,
    }


def run_config(outdir: str, *, create: bool = False, **overrides) -> dict:
    """``soak.run_config`` with this drill's parameters."""
    return soak.run_config(outdir, create=create, defaults=_defaults, **overrides)


def make_datasets(content_dir: str, style_dir: str, n_content: int = 400,
                  n_style: int = 200) -> None:
    """The content set of ``soak.make_dataset`` and a style set of another
    texture family (radial ripples and checkers)."""
    import numpy as np
    from PIL import Image

    soak.make_dataset(content_dir, n_content)
    os.makedirs(style_dir, exist_ok=True)
    rng = np.random.default_rng(42)
    for i in range(n_style):
        h, w = int(rng.integers(280, 512)), int(rng.integers(280, 512))
        yy, xx = np.mgrid[0:h, 0:w]
        cy, cx = rng.integers(0, h), rng.integers(0, w)
        r = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
        img = np.stack([
            127 + 120 * np.sin(2 * np.pi * r / rng.integers(8, 64)),
            127 + 110 * (((xx // rng.integers(8, 48))
                          + (yy // rng.integers(8, 48))) % 2),
            127 + 120 * np.cos(2 * np.pi * r / rng.integers(8, 64)),
        ], axis=-1)
        img += rng.normal(0, 16, img.shape)
        Image.fromarray(np.clip(img, 0, 255).astype("uint8")).save(
            os.path.join(style_dir, f"style{i:04d}.jpg"))
    print(f"wrote {n_style} style images under {style_dir}")


def _cfg(outdir: str):
    """The child's ``AdaINTrainConfig``."""
    from fast_neural_style_transfer_tpu_torch.train.adain import AdaINTrainConfig

    rc = run_config(outdir)
    return AdaINTrainConfig(
        content_dir=rc["content_dir"], style_dir=rc["style_dir"], output_dir=outdir,
        total_steps=rc["total_steps"], batch_size=rc["batch"], precision="bf16",
        image_size=(rc["image_size"], rc["image_size"]),
        checkpoint_every=rc["ckpt_every"], log_every=rc["log_every"], num_workers=8,
        max_checkpoints=100, device=rc["device"])


def _trainer_argv(outdir: str) -> List[str]:
    """argv of one AdaIN training child."""
    code = (
        f"import sys; sys.path.insert(0, {str(soak.REPO)!r});"
        "from fast_neural_style_transfer_tpu_torch.tools.adain_soak import _cfg;"
        "from fast_neural_style_transfer_tpu_torch.train.adain import train_adain;"
        f"train_adain(_cfg({outdir!r}))"
    )
    return [sys.executable, "-c", code]


def run_phase(outdir: str, kill_at_step: Optional[int] = None, **kw) -> int:
    """``soak.run_phase`` with the AdaIN trainer as the child."""
    return soak.run_phase(outdir, kill_at_step, trainer_argv=_trainer_argv, **kw)


def report(outdir: str) -> dict:
    """``soak.evidence`` plus ``final_npz`` (the decoder was saved),
    written to ``<outdir>/report.json``, printed and returned."""
    rep = soak.evidence(outdir)
    rep["final_npz"] = os.path.exists(os.path.join(outdir, "adain_decoder_final.npz"))
    text = json.dumps(rep, indent=2)
    with open(os.path.join(outdir, "report.json"), "w") as f:
        f.write(text + "\n")
    print(text, flush=True)
    return rep


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    cmd = argv[0] if argv else ""
    outdir = (argv[1] if len(argv) > 1
              else os.path.join(tempfile.gettempdir(), "fnst_adain_soak"))
    if cmd == "dataset":
        d = _defaults()
        make_datasets(d["content_dir"], d["style_dir"])
    elif cmd == "phase_a":
        rc = run_config(outdir, create=True)
        return run_phase(outdir, kill_at_step=rc["total_steps"] // 2)
    elif cmd == "phase_b":
        return run_phase(outdir)
    elif cmd == "report":
        report(outdir)
    else:
        raise SystemExit(f"unknown command {cmd!r} (dataset, phase_a, phase_b, report)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
