"""The lower-precision controls come out as not correct under each cell's
limits: the stylizer's own int8 path in the program's place (serving
cells), the AdaIN reference computed in int8, and the training reference
computed in TF32. The CPU runs the int8 stylizer at a small size; the card
runs all three at sizes a test run holds (``pytest -m gpu port_bench/tests``)."""

import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from harness import seeded, serving  # noqa: E402
from harness.systems import for_arch  # noqa: E402
from reference.common import pad_to_bucket  # noqa: E402


def _limits(cell: str) -> dict:
    return json.loads((BENCH / "workloads" / f"{cell}.json").read_text())["limits"]


def _control_gaps(arch: str, side: int, n: int, seed: int, device) -> dict:
    """The control's outputs against the reference on n images of sides
    within the bucket's top 64, run as one batch."""
    system = for_arch(arch)
    weights = system.make_weights(seed, device)
    rng = np.random.default_rng(seed)
    imgs = [im[:h, :w] for im, h, w in zip(seeded.images(n, side, side, seed, device),
                                           rng.integers(side - 63, side + 1, n),
                                           rng.integers(side - 63, side + 1, n))]
    control = system.serve_forward({"precision": "bf16"}, weights, {"bucket_multiple": 64},
                                   device, "control")
    y = control(np.stack([pad_to_bucket(im, 64) for im in imgs]))
    outs = [yi[:im.shape[0], :im.shape[1]] for yi, im in zip(y, imgs)]
    return serving.compare_u8(outs, system.reference_u8(weights, imgs, 64, device))


def _fails(gaps: dict, limits: dict) -> bool:
    return any(gaps[k] > v for k, v in limits.items())


def test_int8_stylizer_control_fails_on_the_cpu():
    gaps = _control_gaps("stylenet", 128, 4, 2 ** 31 + 5, torch.device("cpu"))
    assert _fails(gaps, _limits("stylenet-ref.serve.512-closed")), gaps


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13])
@pytest.mark.parametrize("cell,arch,side", [("stylenet-ref.serve.512-closed", "stylenet", 512),
                                            ("stylenet-ref.serve.256-low", "stylenet", 256),
                                            ("adain-vgg19.serve.512-closed", "adain", 512)])
def test_serving_controls_fail_on_the_card(cell, arch, side, seed):
    gaps = _control_gaps(arch, side, 8, seed, _card())
    assert _fails(gaps, _limits(cell)), gaps


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [2 ** 31 + 21, 2 ** 31 + 22, 2 ** 31 + 23])
def test_tf32_training_control_fails_on_the_card(tmp_path, seed):
    from harness import training
    from harness.trace import Tracer
    from reference.common import float32_math
    from reference.train import train

    device = _card()
    cell = type("Cell", (), {})()
    cell.config = {"arch": "stylenet", "precision": "f32"}
    cell.traffic = json.loads((BENCH / "traffic" / "cli-train256.json").read_text())
    cell.traffic.update(batch_size=8, images=24)
    job = training.Job(cell, seed, device, Tracer(False), str(tmp_path))
    job.close()
    batches = [torch.from_numpy(b).to(device) for b in training.reference_batches(
        job.folder, job.pipe_seed, job.batch_size, cell.traffic["image_size"],
        training.CHECKED_STEPS)]
    with float32_math(tf32=True):
        losses, first, _, after = train(job.weights, job.vgg_weights, batches,
                                        torch.from_numpy(job.style).to(device),
                                        torch.Generator(device=device).manual_seed(job.gen_seed),
                                        lr=job.lr, total_steps=job.total_steps)
    job.checked = (losses, first, after)
    gaps = training.judge(job, device)
    assert _fails(gaps, _limits("stylenet-ref.train.256")), gaps
