"""The port's examples (``fast_neural_style_transfer_tpu_torch/examples``)
run on the CPU (``device="cpu"``) and leave the outputs their JAX
counterparts leave (``tests/test_examples.py``). Each takes a few seconds;
``serving`` spawns two ranks for its height-sharded section."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from fast_neural_style_transfer_tpu_torch.examples import adain, multistyle, quickstart, serving
from fast_neural_style_transfer_tpu_torch.models import load_checkpoint


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)  # the suite runs with several xdist workers
    yield
    torch.set_num_threads(prev)


def test_quickstart_example(tmp_path, capsys):
    quickstart.main(str(tmp_path), device="cpu")
    out = capsys.readouterr().out
    assert "step 3: loss" in out
    assert sorted(os.listdir(tmp_path)) == ["model.onnx", "model.pth", "stylized.jpg"]
    with Image.open(tmp_path / "stylized.jpg") as im:
        assert im.size == (156, 100)
    assert "conv1.conv.weight" in load_checkpoint(str(tmp_path / "model.pth"))


def test_multistyle_example(tmp_path, capsys):
    multistyle.main(str(tmp_path), device="cpu")
    assert "step 3: loss" in capsys.readouterr().out
    for name in ("style0.jpg", "style1.jpg", "blend.jpg", "multistyle_final.npz"):
        assert os.path.exists(tmp_path / name)
    a, b = (np.asarray(Image.open(tmp_path / f"style{i}.jpg")) for i in (0, 1))
    assert not np.array_equal(a, b)  # the two styles' IN rows differ after training


def test_serving_example(tmp_path, capsys):
    serving.main(str(tmp_path), device="cpu")
    out = capsys.readouterr().out
    assert "data-parallel over 2 replicas: max |du8| 0 against one call" in out
    assert "spatial (H over 2 shards): (1, 384, 256, 3) -> (1, 384, 256, 3)" in out
    assert "arbitrary-style DP serving" in out
    assert "HTTP micro-batching: 4 concurrent POSTs -> 4 JPEGs" in out
    assert os.path.exists(tmp_path / "single.jpg")


def test_adain_example(tmp_path, capsys):
    adain.main(str(tmp_path), device="cpu")
    assert "step 3: loss" in capsys.readouterr().out
    for name in ("arbitrary.jpg", "alpha0.0.jpg", "alpha1.0.jpg",
                 "interpolated.jpg", "served_a0.4.jpg", "served_a1.0.jpg",
                 "color_matched.jpg", "color_luma.jpg", "masked_styles.jpg",
                 "adain_decoder.npz"):
        assert os.path.exists(tmp_path / name)
