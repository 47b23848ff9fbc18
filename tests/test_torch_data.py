"""The port's data pipeline, checkpoints and metric logger on the CPU, with
the pipeline held against the JAX package's: the same directory and seed
give the same uint8 batches, bit for bit, and with ``transport="f32"`` the
same float32 batches, bit for bit (both normalize through the same host
library). One f32 step on the f32-transport batch matches the step on the
uint8 batch within 1e-6 relative loss (the two normalize by ``* (1/255)``
and ``/ 255``, one ulp apart for some values).
"""

import json
import os
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from fast_neural_style_transfer_tpu.data import (
    ImageFolderDataset as JaxDataset,
    InputPipeline as JaxPipeline,
)
from fast_neural_style_transfer_tpu_torch.data import ImageFolderDataset, InputPipeline
from fast_neural_style_transfer_tpu_torch.losses import LossTaps, style_targets_from_features
from fast_neural_style_transfer_tpu_torch.models import TransformerNet
from fast_neural_style_transfer_tpu_torch.models.vgg_weights import make_vgg, random_params
from fast_neural_style_transfer_tpu_torch.train.state import create_train_state
from fast_neural_style_transfer_tpu_torch.train.step import make_train_step
from fast_neural_style_transfer_tpu_torch.train.checkpoint import CheckpointManager
from fast_neural_style_transfer_tpu_torch.utils.logging import MetricLogger


@pytest.fixture
def image_dir(tmp_path):
    rng = np.random.default_rng(0)
    sub = tmp_path / "nested"
    sub.mkdir()
    for i in range(11):
        arr = rng.integers(0, 256, (40 + i, 50, 3), dtype=np.uint8)
        Image.fromarray(arr).save((sub if i % 2 else tmp_path) / f"img_{i}.jpg")
    (tmp_path / "notes.txt").write_text("not an image")
    with open(tmp_path / "zz_corrupt.jpg", "wb") as f:
        f.write(b"\xff\xd8 not a real jpeg")
    return str(tmp_path)


@pytest.mark.parametrize("drop_last", [True, False])
def test_batches_match_jax_pipeline(image_dir, drop_last):
    """Two epochs (so two permutations), a corrupt file substituted the
    same way, and for drop_last=False the wrap-around fill."""
    jds = JaxDataset(image_dir, (24, 32), seed=5)
    tds = ImageFolderDataset(image_dir, (24, 32), seed=5)
    assert tds.files == jds.files
    want = list(JaxPipeline(jds, 5, seed=5, num_workers=2, drop_last=drop_last,
                            transport="u8").host_batches(num_epochs=2))
    got = list(InputPipeline(tds, 5, seed=5, num_workers=2, drop_last=drop_last,
                             device="cpu").host_batches(num_epochs=2))
    assert len(got) == len(want) == (4 if drop_last else 6)  # 12 files
    for g, w in zip(got, want):
        assert g.dtype == np.uint8 and g.shape == (5, 24, 32, 3)
        np.testing.assert_array_equal(g, np.asarray(w))


def test_device_batches_and_padding(image_dir):
    tds = ImageFolderDataset(image_dir, (16, 16), seed=1)
    pipe = InputPipeline(tds, 5, seed=1, num_workers=2, pad_to_multiple=8, device="cpu")
    np.testing.assert_array_equal(pipe.batch_mask, [1] * 5 + [0] * 3)
    host = next(pipe.host_batches(num_epochs=1))
    dev = next(pipe.device_batches(num_epochs=1))
    assert isinstance(dev, torch.Tensor) and dev.dtype == torch.uint8
    assert dev.shape == (8, 16, 16, 3)
    np.testing.assert_array_equal(dev.numpy(), host)
    np.testing.assert_array_equal(host[5:], np.repeat(host[4:5], 3, axis=0))
    # an epoch-bounded stream ends; an early exit stops the producer
    assert len(list(pipe.device_batches(num_epochs=1))) == 2
    it = pipe.device_batches()
    next(it)
    it.close()
    with pytest.raises(ValueError, match="every epoch would be empty"):
        InputPipeline(tds, 50, device="cpu")


def test_f32_transport_matches_jax(image_dir):
    jds = JaxDataset(image_dir, (24, 32), seed=3)
    tds = ImageFolderDataset(image_dir, (24, 32), seed=3)
    want = list(JaxPipeline(jds, 4, seed=3, num_workers=2,
                            transport="f32").host_batches(num_epochs=2))
    pipe = InputPipeline(tds, 4, seed=3, num_workers=2, transport="f32", device="cpu")
    got = list(pipe.host_batches(num_epochs=2))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == (4, 24, 32, 3)
        np.testing.assert_array_equal(g, np.asarray(w))
    for d, g in zip(pipe.device_batches(num_epochs=2), got):
        assert d.dtype == torch.float32
        np.testing.assert_array_equal(d.numpy(), g)


def test_f32_transport_step_matches_u8_step(image_dir):
    tds = ImageFolderDataset(image_dir, (32, 32), seed=0)
    u8 = next(InputPipeline(tds, 2, num_workers=2, device="cpu").device_batches(1))
    f32 = next(InputPipeline(tds, 2, num_workers=2, transport="f32",
                             device="cpu").device_batches(1))
    vgg = make_vgg(random_params(0), "cpu")
    style = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        grams = style_targets_from_features(vgg(style, LossTaps().style_taps))
    losses = []
    for batch in (u8, f32):
        torch.manual_seed(0)
        state = create_train_state(TransformerNet().to(memory_format=torch.channels_last))
        metrics = make_train_step(dropout=False)(state, vgg, batch, grams)
        losses.append(float(metrics["loss"]))
        assert state.step == 1
    assert abs(losses[1] - losses[0]) <= 1e-6 * abs(losses[0])


def test_pipeline_options_refused(image_dir):
    tds = ImageFolderDataset(image_dir, (16, 16), seed=1)
    with pytest.raises(ValueError, match="prefetch must be >= 1"):
        InputPipeline(tds, 2, prefetch=0, device="cpu")
    with pytest.raises(ValueError, match="transport must be"):
        InputPipeline(tds, 2, transport="f16", device="cpu")
    assert InputPipeline(tds, 2, device="cpu").prefetch == 2  # JAX's default


def _pipeline_threads():
    return [t for t in threading.enumerate() if t.name.startswith("fnst-pipeline")]


@pytest.mark.parametrize("prefetch", [1, 2, 3])
def test_prefetch_keeps_every_batch_in_order(image_dir, prefetch):
    """Two finite epochs come through whole and in order, however deep the
    queue; stopping early leaves no producer or decode thread behind."""
    tds = ImageFolderDataset(image_dir, (16, 16), seed=2)
    pipe = InputPipeline(tds, 3, seed=2, num_workers=2, prefetch=prefetch, device="cpu")
    want = list(pipe.host_batches(num_epochs=2))
    got = list(pipe.device_batches(num_epochs=2))
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    it = pipe.device_batches()  # unbounded
    next(it)
    assert _pipeline_threads()
    it.close()
    for t in _pipeline_threads():
        t.join(timeout=30)
    assert not _pipeline_threads()


def test_checkpoint_manager(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    assert mgr.latest_step() is None
    for label in (5, 10, 15):
        mgr.save(label, {"step": label, "w": torch.full((2,), float(label))})
    assert mgr.labels() == [10, 15] and mgr.latest_step() == 15
    assert not [f for f in os.listdir(mgr.directory) if f.endswith(".tmp")]
    back = mgr.restore()
    assert back["step"] == 15 and torch.equal(back["w"], torch.full((2,), 15.0))
    assert mgr.restore(10)["step"] == 10
    orbax = tmp_path / "orbax"
    (orbax / "5000").mkdir(parents=True)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        CheckpointManager(str(orbax))


def test_metric_logger_means(tmp_path, capsys):
    path = str(tmp_path / "m.jsonl")
    log = MetricLogger(path, print_every=2)
    log.update({"loss": torch.tensor(1.0), "lr": 0.5})
    assert not log.should_log(1)
    log.update({"loss": torch.tensor(3.0), "lr": 0.25})
    assert log.should_log(2)
    rec = log.flush(2)
    log.close()
    assert rec["loss"] == 2.0 and rec["lr"] == 0.375 and log.pending == 0
    with open(path) as f:
        assert json.loads(f.readline())["step"] == 2
    assert "loss=2" in capsys.readouterr().out
