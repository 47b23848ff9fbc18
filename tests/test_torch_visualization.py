"""The port's loss-curve plots (``utils/visualization.py``) against the JAX
package's, and the trainers' final plot.

- ``read_metrics`` agrees with JAX's record for record (exact equality of
  the parsed dicts) on a torn, resume-overlapped file and on the committed
  soak's ``metrics.jsonl``.
- ``plot_loss_curves`` writes JAX's file names.
- Both trainers' tiny CPU runs (64x64, 2 steps) end with their PNGs; a
  plotting error, or no matplotlib, prints the skip line and the run
  still ends normally.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from fast_neural_style_transfer_tpu.utils import visualization as jax_vis
from fast_neural_style_transfer_tpu_torch.cli import begin_training
from fast_neural_style_transfer_tpu_torch.train.adain import AdaINTrainConfig, train_adain
from fast_neural_style_transfer_tpu_torch.utils import visualization as vis

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOAK_METRICS = os.path.join(ROOT, "evidence", "soak40k_r5", "metrics.jsonl")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)  # the suite runs with several xdist workers
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def torn_metrics(tmp_path):
    """Steps 1-6, a resume from step 3 that logs 4-6 again with other
    values, and a torn last line."""
    path = tmp_path / "metrics.jsonl"
    rows = [{"step": s, "loss": 10.0 - s, "content_loss": 1.0 + s, "style_loss": 2.0,
             "tv_loss": 0.5} for s in range(1, 7)]
    rows += [{"step": s, "loss": 20.0 - s, "content_loss": 3.0, "style_loss": 2.5,
              "tv_loss": 0.25} for s in range(4, 8)]
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
        f.write("\n")
        f.write('{"step": 8, "loss": 1')  # torn by a preempted writer
    return str(path)


@pytest.mark.parametrize("which", ["torn", "soak"])
def test_read_metrics_matches_jax(torn_metrics, which):
    path = torn_metrics if which == "torn" else SOAK_METRICS
    ours, theirs = vis.read_metrics(path), jax_vis.read_metrics(path)
    assert ours == theirs
    steps = [r["step"] for r in ours]
    assert steps == sorted(set(steps))
    if which == "torn":
        assert steps == list(range(1, 8))
        assert ours[4]["loss"] == 15.0  # the resumed run's step 5 wins


def test_plot_loss_curves_writes_jax_names(torn_metrics, tmp_path):
    ours = vis.plot_loss_curves(torn_metrics, str(tmp_path / "ours"))
    theirs = jax_vis.plot_loss_curves(torn_metrics, str(tmp_path / "theirs"))
    names = sorted(os.path.basename(p) for p in ours)
    assert names == sorted(os.path.basename(p) for p in theirs)
    assert names == ["content_loss.png", "loss.png", "style_loss.png", "tv_loss.png"]
    for p in ours:
        with Image.open(p) as im:
            assert im.size[0] > 100 and im.size[1] > 100


def _images(root, n, hw, seed):
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (*hw, 3), dtype=np.uint8)).save(
            os.path.join(root, f"{i}.jpg"))
    return str(root)


def _train_style(tmp_path, steps=2):
    data = _images(tmp_path / "data", 4, (70, 72), seed=1)
    style = os.path.join(_images(tmp_path / "s", 1, (64, 64), seed=2), "0.jpg")
    out = str(tmp_path / "out")
    begin_training.main([
        "--device", "cpu", "--dataset_dir", data, "--style_image", style,
        "--output_dir", out, "--batch_size", "2", "--image_size", "64", "64",
        "--num_workers", "2", "--training_monitor_content_image", "",
        "--total_steps", str(steps)])
    return out


@pytest.mark.parametrize("trainer", ["style_transfer", "adain"])
def test_trainers_end_with_loss_curves(tmp_path, trainer, capsys):
    if trainer == "style_transfer":
        out = _train_style(tmp_path)
        want = ["content_loss.png", "loss.png", "style_loss.png", "tv_loss.png"]
    else:
        out = str(tmp_path / "out")
        train_adain(AdaINTrainConfig(
            content_dir=_images(tmp_path / "c", 4, (64, 64), seed=3),
            style_dir=_images(tmp_path / "s", 4, (64, 64), seed=4),
            output_dir=out, total_steps=2, batch_size=2, image_size=(64, 64),
            num_workers=2, log_every=1, device="cpu"))
        want = ["content_loss.png", "loss.png", "style_loss.png"]
    assert sorted(f for f in os.listdir(out) if f.endswith(".png")) == want
    assert "loss-curve plotting skipped" not in capsys.readouterr().out


def test_plotting_failure_never_fails_the_run(tmp_path, monkeypatch, capsys):
    def boom(*a, **k):
        raise RuntimeError("boom")

    monkeypatch.setattr(vis, "plot_loss_curves", boom)
    out = _train_style(tmp_path, steps=1)  # returns normally: the CLI exits 0
    assert os.path.exists(os.path.join(out, "style_transfer_final.npz"))
    assert not [f for f in os.listdir(out) if f.endswith(".png")]
    assert "loss-curve plotting skipped: boom" in capsys.readouterr().out


def test_no_matplotlib_prints_the_skip_line(torn_metrics, monkeypatch, capsys):
    """The card's machine has no matplotlib: the skip line is the result."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    vis.plot_after_training(os.path.dirname(torn_metrics))
    assert "loss-curve plotting skipped: " in capsys.readouterr().out
    assert not [f for f in os.listdir(os.path.dirname(torn_metrics)) if f.endswith(".png")]
