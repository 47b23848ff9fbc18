"""Preemption drill for the training loop: a bf16 run SIGTERMed once at half
way, then resumed to the end (the JAX package's ``tools/soak.py``).

    python -m fast_neural_style_transfer_tpu_torch.tools.soak dataset [dir] [n_images]
    python -m fast_neural_style_transfer_tpu_torch.tools.soak phase_a [outdir]
    python -m fast_neural_style_transfer_tpu_torch.tools.soak phase_b [outdir]
    python -m fast_neural_style_transfer_tpu_torch.tools.soak report  [outdir]

``dataset`` synthesizes a content set; ``phase_a`` trains in a child
process and SIGTERMs it once when ``metrics.jsonl`` reaches half the steps
(the loop finishes the step in flight and checkpoints); ``phase_b`` resumes
from the latest checkpoint to the end; ``report`` prints the evidence (and
returns it): the logged rows, the largest step, steps logged twice, the
checkpoints, the first and last losses and the non-finite skips.

The run's parameters come from the environment (``FNST_SOAK_STEPS`` 2200,
``FNST_SOAK_BATCH`` 20, ``FNST_SOAK_CKPT_EVERY`` 250, ``FNST_SOAK_DATASET``
under the temporary directory; 256x256, a row logged every 50 steps, on
the card) and are pinned to ``<outdir>/soak_config.json`` by the first
phase (``run_config``), so a later phase resumes with the run's own
parameters. A short or CPU drill pins its own first:
``run_config(outdir, create=True, total_steps=6, image_size=64,
log_every=1, device="cpu", ...)``. The style and monitor images are
synthesized into ``outdir``. The child imports the package from this
checkout (its root is found from this file).
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, List, Optional

REPO = Path(__file__).resolve().parents[2]
# a rowless child gets this long on top of stall_s: its first step builds
# the two CUDA sources with nvcc when no build is cached (~30-60 s), and the
# host library with g++
_COMPILE_GRACE_S = 300.0


def _defaults() -> dict:
    env = os.environ.get
    return {
        "total_steps": int(env("FNST_SOAK_STEPS", 2200)),
        "batch": int(env("FNST_SOAK_BATCH", 20)),
        "ckpt_every": int(env("FNST_SOAK_CKPT_EVERY", 250)),
        "image_size": 256,
        "log_every": 50,
        "dataset_dir": env("FNST_SOAK_DATASET",
                           os.path.join(tempfile.gettempdir(), "fnst_soak_ds")),
        "device": None,
    }


def run_config(outdir: str, *, create: bool = False,
               defaults: Callable[[], dict] = _defaults, **overrides) -> dict:
    """The run's parameters: ``<outdir>/soak_config.json`` if present, else
    ``defaults()`` (the environment's) updated with ``overrides`` (written
    there when ``create``)."""
    path = os.path.join(outdir, "soak_config.json")
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    rc = {**defaults(), **overrides}
    if create:
        os.makedirs(outdir, exist_ok=True)
        with open(path, "w") as f:
            json.dump(rc, f)
    return rc


def make_dataset(root: str, n: int = 400) -> None:
    """``n`` seeded JPEGs (280-511 px a side: stripes, a flat channel and
    noise) under ``root``."""
    import numpy as np
    from PIL import Image

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(0)
    for i in range(n):
        h, w = int(rng.integers(280, 512)), int(rng.integers(280, 512))
        yy, xx = np.mgrid[0:h, 0:w]
        img = np.stack([
            127 + 120 * np.sin(2 * np.pi * (xx / rng.integers(16, 200)
                                            + rng.random())),
            127 + 120 * np.cos(2 * np.pi * (yy / rng.integers(16, 200)
                                            + rng.random())),
            rng.integers(0, 255) * np.ones_like(xx, dtype=np.float64),
        ], axis=-1)
        img += rng.normal(0, 24, img.shape)
        Image.fromarray(np.clip(img, 0, 255).astype("uint8")).save(
            os.path.join(root, f"img{i:04d}.jpg"))
    print(f"wrote {n} images under {root}")


def synth_image(path: str, seed: int, size: int = 384) -> str:
    """A seeded smooth colour-field JPEG at ``path`` (kept if present)."""
    if not os.path.exists(path):
        import numpy as np
        from PIL import Image

        rng = np.random.default_rng(seed)
        coarse = rng.integers(0, 256, (12, 12, 3), dtype=np.uint8)
        img = Image.fromarray(coarse).resize((size, size), Image.BICUBIC)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        img.save(path, quality=95)
    return path


def _cfg(outdir: str):
    """The child's ``TrainConfig``."""
    from fast_neural_style_transfer_tpu_torch.train.loop import TrainConfig

    rc = run_config(outdir)
    return TrainConfig(
        style_image=os.path.join(outdir, "style.jpg"),
        dataset_dir=rc["dataset_dir"],
        output_dir=outdir,
        monitor_image=os.path.join(outdir, "monitor.jpg"),
        total_steps=rc["total_steps"],
        batch_size=rc["batch"],
        image_size=(rc["image_size"], rc["image_size"]),
        precision="bf16",
        checkpoint_every=rc["ckpt_every"],
        log_every=rc["log_every"],
        monitor_every=500,
        max_checkpoints=100,  # keep the whole chain as evidence
        num_workers=8,
        device=rc["device"],
    )


def _last_step(metrics: str) -> int:
    try:
        with open(metrics) as f:
            line = None
            for line in f:
                pass
        return json.loads(line).get("step", -1) if line else -1
    except (OSError, ValueError):
        return -1


def _trainer_argv(outdir: str) -> List[str]:
    """argv of one training child (a function of its own so tests can put
    in a fake trainer)."""
    code = (
        f"import sys; sys.path.insert(0, {str(REPO)!r});"
        "from fast_neural_style_transfer_tpu_torch.tools.soak import _cfg;"
        "from fast_neural_style_transfer_tpu_torch.train.loop import "
        "train_style_transfer;"
        f"train_style_transfer(_cfg({outdir!r}))"
    )
    return [sys.executable, "-c", code]


def run_phase(outdir: str, kill_at_step: Optional[int] = None, *,
              trainer_argv: Optional[Callable[[str], List[str]]] = None,
              stall_s: Optional[float] = None, max_restarts: int = 50,
              poll_s: float = 5.0, backoff_s: float = 30.0,
              deadline_s: float = float("inf")) -> int:
    """Run training in a child process (``trainer_argv(outdir)``, default
    ``_trainer_argv``); SIGTERM it exactly once when ``metrics.jsonl``
    reaches ``kill_at_step`` (the drill). Returns the child's exit code.

    Stall watchdog: if ``metrics.jsonl`` stops advancing for ``stall_s``
    (``FNST_SOAK_STALL_S``, default 480 s), the child is SIGKILLed and
    relaunched (after ``backoff_s``); the loop resumes from its latest
    checkpoint. A child with no row of its own yet (the loop creates the
    file empty at start-up, and a relaunch inherits the previous child's
    rows) is measured from its launch, with ``_COMPILE_GRACE_S`` more. A
    child that exits before the drill step is relaunched. Past
    ``deadline_s`` from the start the child is killed and ``TimeoutError``
    raised."""
    if stall_s is None:
        stall_s = float(os.environ.get("FNST_SOAK_STALL_S", 480))
    argv_of = trainer_argv or _trainer_argv
    os.makedirs(outdir, exist_ok=True)
    synth_image(os.path.join(outdir, "style.jpg"), seed=1)
    synth_image(os.path.join(outdir, "monitor.jpg"), seed=2)
    metrics = os.path.join(outdir, "metrics.jsonl")
    t_start = time.time()
    sent = False
    proc = None
    for attempt in range(max_restarts):
        proc = subprocess.Popen(argv_of(outdir), cwd=str(REPO))
        launched = time.time()
        stalled = False
        try:
            while proc.poll() is None:
                time.sleep(poll_s)
                if time.time() - t_start > deadline_s:
                    raise TimeoutError(f"soak phase passed its {deadline_s:.0f} s deadline")
                step = _last_step(metrics)
                try:
                    st = os.stat(metrics)
                    if st.st_size > 0 and st.st_mtime >= launched:
                        fresh_for = time.time() - st.st_mtime
                    else:
                        fresh_for = time.time() - launched - _COMPILE_GRACE_S
                except OSError:
                    fresh_for = time.time() - launched - _COMPILE_GRACE_S
                if fresh_for > stall_s:
                    print(f"[soak] metrics stalled {fresh_for:.0f}s at step "
                          f"{step}: SIGKILL + resume (attempt {attempt + 1})",
                          flush=True)
                    proc.kill()
                    proc.wait()
                    stalled = True
                    break
                if not sent and kill_at_step is not None and step >= kill_at_step:
                    print(f"metrics at step {step}: sending SIGTERM", flush=True)
                    proc.send_signal(signal.SIGTERM)
                    sent = True
        finally:
            if proc.poll() is None:  # the deadline, or an interrupt
                proc.kill()
                proc.wait()
        if stalled:
            time.sleep(backoff_s)
            continue
        if kill_at_step is None or sent:
            break
        print("[soak] child exited before the drill step; relaunching", flush=True)
    print("phase exit:", proc.returncode, "(SIGTERM sent:", sent, ")", flush=True)
    return proc.returncode


def evidence(outdir: str) -> dict:
    """The drill's evidence from ``metrics.jsonl`` and the checkpoints."""
    from fast_neural_style_transfer_tpu_torch.train.checkpoint import CheckpointManager

    with open(os.path.join(outdir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    steps = [r["step"] for r in rows if "step" in r]
    losses = [(r["step"], r["loss"]) for r in rows if "loss" in r]
    rep = {
        "logged_rows": len(steps),
        "max_step": max(steps),
        "duplicate_steps_after_resume": len(steps) - len(set(steps)),
        "checkpoints": CheckpointManager(os.path.join(outdir, "checkpoints")).labels(),
        "first_loss": losses[0],
        "last_loss": losses[-1],
        "nonfinite_skips": sum(r.get("skipped_nonfinite", 0) for r in rows),
    }
    return rep


def report(outdir: str) -> dict:
    """``evidence``, printed as JSON and returned."""
    rep = evidence(outdir)
    print(json.dumps(rep, indent=2), flush=True)
    return rep


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    cmd = argv[0] if argv else ""
    outdir = (argv[1] if len(argv) > 1
              else os.path.join(tempfile.gettempdir(), "fnst_soak_out"))
    if cmd == "dataset":
        make_dataset(argv[1] if len(argv) > 1 else _defaults()["dataset_dir"],
                     int(argv[2]) if len(argv) > 2 else 400)
    elif cmd == "phase_a":
        rc = run_config(outdir, create=True)  # pin the parameters for later phases
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
