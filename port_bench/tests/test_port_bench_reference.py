"""The plain references against the port on the CPU at a tiny size: the
stylizer's forward and its u8 serving path, AdaIN with a cached style, and
the training step's loss and gradients."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from harness import seeded  # noqa: E402
from harness.training import compare  # noqa: E402
from harness.systems import adain as adain_system  # noqa: E402
from harness.systems import stylenet as stylenet_system  # noqa: E402
from reference import stylenet, train, vgg  # noqa: E402

CPU = torch.device("cpu")


def test_stylenet_reference_matches_the_port_forward():
    from fast_neural_style_transfer_tpu_torch.core.dtypes import Precision
    from fast_neural_style_transfer_tpu_torch.models.transformer import TransformerNet

    w = seeded.weights(stylenet.param_spec(), 3, CPU)
    net = TransformerNet()
    net.load_state_dict(w, strict=True)
    x = torch.randn(2, 3, 48, 64)
    with torch.no_grad():
        got = net.eval()(x.permute(0, 2, 3, 1).contiguous(), Precision.f32())
        want = stylenet.forward(w, x).permute(0, 2, 3, 1)
    assert torch.allclose(got, want, atol=1e-4, rtol=1e-4)


def _u8_gap(system, arch_weights, make_program):
    imgs = [im[:h, :w] for im, (h, w) in zip(seeded.images(3, 64, 64, 4, CPU),
                                             [(64, 64), (50, 61), (33, 40)])]
    fwd = make_program(arch_weights)
    got = [fwd(im) for im in imgs]
    want = system.reference_u8(arch_weights, imgs, 64, CPU)
    return max(int(np.abs(g.astype(int) - r.astype(int)).max()) for g, r in zip(got, want))


def test_stylenet_u8_reference_matches_the_port_stylizer():
    from fast_neural_style_transfer_tpu_torch.infer.stylize import Stylizer

    w = stylenet_system.make_weights(5, CPU)
    gap = _u8_gap(stylenet_system, w,
                  lambda w: Stylizer(w["net"], precision="f32", device="cpu").stylize_u8)
    assert gap <= 1


def test_adain_u8_reference_matches_the_port_cached_style():
    from fast_neural_style_transfer_tpu_torch.infer.adain import ArbitraryStylizer

    w = adain_system.make_weights(6, CPU)
    w["style"] = w["style"][:64, :64]

    def program(w):
        sty = ArbitraryStylizer(w["decoder"], w["vgg"], precision="f32", device="cpu")
        return sty.set_style_u8(w["style"]).stylize_u8

    assert _u8_gap(adain_system, w, program) <= 1


def test_training_reference_matches_the_port_step():
    from fast_neural_style_transfer_tpu_torch.losses import LossTaps, style_targets_from_features
    from fast_neural_style_transfer_tpu_torch.models.transformer import TransformerNet
    from fast_neural_style_transfer_tpu_torch.models.vgg_weights import make_vgg
    from fast_neural_style_transfer_tpu_torch.train.schedule import LossWeightSchedule
    from fast_neural_style_transfer_tpu_torch.train.state import create_train_state
    from fast_neural_style_transfer_tpu_torch.train.step import make_train_step
    from fast_neural_style_transfer_tpu_torch.utils.image_io import normalize_image

    w = seeded.weights(stylenet.param_spec(), 7, CPU)
    vw = seeded.weights(vgg.param_spec(), 8, CPU)
    batch = seeded.images(3, 32, 32, 9, CPU)
    style = seeded.images(1, 32, 32, 10, CPU)[0]
    net = TransformerNet()
    net.load_state_dict(w, strict=True)
    state = create_train_state(net, 1e-3, 80_000)
    taps = LossTaps()
    vggm = make_vgg(vw, CPU)
    with torch.no_grad():
        grams = [g.detach() for g in style_targets_from_features(
            vggm(torch.from_numpy(normalize_image(style[None])), taps.style_taps))]
    step = make_train_step(taps=taps, weight_schedule=LossWeightSchedule())
    metrics = step(state, vggm, torch.from_numpy(batch), grams,
                   torch.Generator().manual_seed(11))
    beta1 = 0.9
    got = {n: state.optimizer.adam.state[p]["exp_avg"] / (1 - beta1)
           for n, p in net.named_parameters()}
    losses, first, raw, after = train.train(w, vw, [torch.from_numpy(batch)],
                                          torch.from_numpy(style),
                                          torch.Generator().manual_seed(11),
                                          lr=1e-3, total_steps=80_000)
    gaps = compare([float(metrics["loss"])], got,
                   {n: p.detach() for n, p in net.named_parameters()}, w,
                   losses, first, raw, after)
    assert gaps["loss1_gap"] <= 1e-5 and gaps["grad_gap"] <= 1e-3
    assert gaps["leaves_left_out"] == 14  # the conv biases under instance norm
