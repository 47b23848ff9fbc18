"""fnst-parity of the port (``cli/parity.py``) against the JAX package's.

Both run on a stand-in reference repository (``torch_reference_stand_in``:
a plain-torch ``StyleTransferNet`` in the reference ``.pth`` layout,
written to a temp dir) and a seeded ``.pth`` whose IN affines are drawn
away from identity, in both input modes. Bounds: the port's SSIM within
1e-4 of JAX's; the saved images within |du8| <= 1; the JSON line carries
JAX's keys; a missing repository raises JAX's error.
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from fast_neural_style_transfer_tpu.cli import parity as jax_parity
from fast_neural_style_transfer_tpu_torch.cli import parity
from fast_neural_style_transfer_tpu_torch.models import TransformerNet
from torch_reference_stand_in import write_reference_repo


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)  # the suite runs with several xdist workers
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parity")
    ref = write_reference_repo(str(tmp / "reference"))
    torch.manual_seed(3)
    net = TransformerNet()
    with torch.no_grad():
        for name, p in net.named_parameters():
            if p.dim() == 1 and ".conv" not in name and "upsample" not in name:
                p.copy_(torch.randn(p.shape) * 0.5 + (1.0 if name.endswith("weight") else 0.0))
    pth = str(tmp / "ckpt.pth")
    torch.save({"model_state_dict": net.state_dict(), "iteration": 1234}, pth)
    content = str(tmp / "content.jpg")
    img = np.random.default_rng(0).integers(0, 256, (30, 22, 3), dtype=np.uint8)
    Image.fromarray(img).resize((110, 150), Image.BICUBIC).save(content)
    return ref, pth, content, tmp


@pytest.mark.parametrize("mode", ["reference-exact", "canonical"])
def test_parity_matches_jax(setup, mode):
    ref, pth, content, tmp = setup
    ours = parity.run_parity(pth, content, reference_repo=ref, size=(64, 64), mode=mode,
                             output_dir=str(tmp / f"ours_{mode}"), device="cpu")
    theirs = jax_parity.run_parity(pth, content, reference_repo=ref, size=(64, 64),
                                   mode=mode, output_dir=str(tmp / f"theirs_{mode}"))
    assert set(ours) == set(theirs)
    assert abs(ours["value"] - theirs["value"]) <= 1e-4
    assert ours["pass"] and ours["mode"] == mode and ours["size"] == [64, 64]
    for name in ("parity_ours.jpg", "parity_reference.jpg"):
        a = np.asarray(Image.open(tmp / f"ours_{mode}" / name)).astype(int)
        b = np.asarray(Image.open(tmp / f"theirs_{mode}" / name)).astype(int)
        assert a.shape == b.shape == (64, 64, 3)
        assert np.abs(a - b).max() <= 1


def test_parity_cli_prints_jax_keys(setup, capsys):
    ref, pth, content, tmp = setup
    common = ["--reference_pth", pth, "--content", content, "--size", "64", "64",
              "--reference_repo", ref, "--reference_sample", content]
    assert parity.main(common + ["--device", "cpu"]) == 0
    ours = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jax_parity.main(common) == 0
    theirs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(ours) == set(theirs) and "ssim_vs_sample_file" in ours
    assert ours["metric"] == "ssim_vs_reference_net" and ours["threshold"] == 0.98
    assert abs(ours["ssim_vs_sample_file"] - theirs["ssim_vs_sample_file"]) <= 1e-4


def test_missing_reference_repo_raises_jax_error(setup, tmp_path):
    _, pth, content, _ = setup
    missing = str(tmp_path / "nowhere")
    with pytest.raises(FileNotFoundError) as ours:
        parity.run_parity(pth, content, reference_repo=missing, device="cpu")
    with pytest.raises(FileNotFoundError) as theirs:
        jax_parity.run_parity(pth, content, reference_repo=missing)
    assert str(ours.value) == str(theirs.value)
    assert os.path.basename(missing) in str(ours.value)
