"""The benchmark's operation and byte counts against PyTorch's own
``FlopCounterMode`` on the plain references, and the byte bounds against
the per-step bounds the repository's kernel table records."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

import torch  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from counts import adain as adain_counts  # noqa: E402
from counts import stylenet as stylenet_counts  # noqa: E402
from counts.peaks import H100, least_seconds  # noqa: E402
from harness import seeded  # noqa: E402
from reference import adain, stylenet, train, vgg  # noqa: E402


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_stylenet_forward_flops_match_flop_counter():
    w = seeded.weights(stylenet.param_spec(), 1, "cpu")
    x = torch.randn(2, 3, 64, 96)
    with torch.no_grad():
        got = _counted(lambda: stylenet.forward(w, x))
    assert got == 2 * stylenet_counts.forward_flops(64, 96)


def test_adain_forward_flops_match_flop_counter():
    w = {"decoder": seeded.weights(adain.param_spec(), 1, "cpu"),
         "vgg": seeded.weights(vgg.param_spec(), 2, "cpu")}
    x = torch.randn(2, 3, 64, 64)
    mean, std = torch.zeros(1, 512, 1, 1), torch.ones(1, 512, 1, 1)
    with torch.no_grad():
        got = _counted(lambda: adain.forward(w["decoder"], w["vgg"], x, mean, std))
    assert got == 2 * adain_counts.forward_flops(64, 64)


def test_train_step_flops_match_flop_counter():
    w = seeded.weights(stylenet.param_spec(), 1, "cpu")
    p = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    vw = seeded.weights(vgg.param_spec(), 2, "cpu")
    batch = torch.from_numpy(seeded.images(2, 32, 32, 3, "cpu"))
    grams = [g.detach() for g in train.style_grams(vw, batch[0])]

    def step():
        total = train.loss(p, vw, batch, grams, None)
        torch.autograd.grad(total, list(p.values()))

    assert _counted(step) == 2 * stylenet_counts.train_step_flops(32, 32)


def test_kernel_bounds_match_the_recorded_per_step_bounds():
    """The IN forward, IN backward and conv1_1 dx bounds of one f32 B=20
    step at 256x256 (0.751, 1.127 and 0.105 ms in the kernel table)."""
    ms = lambda cost: 1e3 * least_seconds(*cost, "f32", H100)
    assert abs(ms(stylenet_counts.in_fwd_cost(20, 256, 256, 4)) - 0.751) < 0.001
    assert abs(ms(stylenet_counts.in_bwd_cost(20, 256, 256, 4)) - 1.127) < 0.001
    assert abs(ms(stylenet_counts.conv_dx_cost(20, 256, 256, 4)) - 0.105) < 0.001
    assert len(stylenet_counts.in_sites(1, 256, 256)) == 14
