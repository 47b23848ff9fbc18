"""The reflect-pad kernel of the port (``ops/cuda_pad.py``) and its routing
(``ops/conv.py::reflect_pad_hw``).

- On the CPU: the kernel's plain version against ``F.pad(F.interpolate(
  torch.relu(x)))`` bit for bit; the routing (the CPU takes the plain
  version, a tensor that needs a gradient takes autograd's, any other
  device the kernel, which refuses all but CUDA); the AdaIN decoder with
  its ReLUs and upsamples folded into the pads against the unfolded
  composition; the planner's routes and grids; the build's source list.
- The ``gpu``-marked tests hold the kernel against its plain version and
  against ``F.pad`` at every pad site of the serving cells, count its
  launches per forward, and hold the three stylizers' u8 outputs to those
  of the ``F.pad`` route. They decide inside the test whether a card
  exists. This file imports no JAX.
"""

import pathlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fast_neural_style_transfer_tpu_torch.core.dtypes import Precision
from fast_neural_style_transfer_tpu_torch.models.adain import _DECODER_CFG, AdaINDecoder
from fast_neural_style_transfer_tpu_torch.ops import _build, conv, cuda_pad

PORT_DIR = pathlib.Path(conv.__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs with several xdist workers
    yield
    torch.set_num_threads(prev)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int16 if t.element_size() == 2 else torch.int32)


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def _composed(x, pad, relu=False, upsample=1):
    """What the port computed before the kernel: ReLU, nearest x2
    upsample, reflect pad, each its own pass."""
    if relu:
        x = torch.relu(x)
    if upsample != 1:
        x = F.interpolate(x, scale_factor=upsample, mode="nearest")
        x = x.contiguous(memory_format=torch.channels_last)
    x = F.pad(x, (pad, pad, pad, pad), mode="reflect")
    return x.contiguous(memory_format=torch.channels_last)


def _activation(shape, dtype, seed, device="cpu"):
    """A seeded channels_last activation with negatives and some -0."""
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))
    x[..., ::5] = -0.0
    return x.to(device, dtype).contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("relu", [False, True], ids=["id", "relu"])
@pytest.mark.parametrize("upsample", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("c", [3, 32, 64, 256, 512])
@pytest.mark.parametrize("pad", [1, 4])
def test_plain_matches_fpad(pad, c, dtype, upsample, relu):
    """Odd and even sides, and the smallest side the pad allows."""
    for i, (h, w) in enumerate([(pad + 1, pad + 2), (6, 7), (9, 8)]):
        x = _activation((2, c, h, w), dtype, seed=i)
        got = cuda_pad.reflect_pad_reference(x, pad, relu=relu, upsample=upsample)
        assert got.is_contiguous(memory_format=torch.channels_last)
        assert _same_bits(got, _composed(x, pad, relu, upsample)), (h, w)


def test_plain_refuses_a_pad_the_sides_cannot_mirror():
    x = torch.zeros(1, 8, 3, 5)
    with pytest.raises(ValueError, match="reflect padding 3"):
        cuda_pad.reflect_pad_reference(x, 3)
    assert cuda_pad.reflect_pad_reference(x, 3, upsample=2).shape == (1, 8, 12, 16)
    with pytest.raises(ValueError, match="upsamples by 1 or 2"):
        cuda_pad.reflect_pad_reference(x, 1, upsample=3)


def test_cpu_takes_the_plain_version_and_launches_nothing(monkeypatch):
    before = conv.reflect_pad_hw.launches
    seen = []
    monkeypatch.setattr(conv, "reflect_pad_reference",
                        lambda *a, **k: seen.append(k) or cuda_pad.reflect_pad_reference(*a, **k))
    monkeypatch.setattr(conv, "reflect_pad", lambda *a, **k: pytest.fail("kernel on the CPU"))
    x = _activation((2, 16, 6, 6), torch.float32, seed=0)
    with torch.no_grad():
        y = conv.reflect_pad_hw(x, 1, relu=True, upsample=2)
    assert seen == [{"relu": True, "upsample": 2}]
    assert _same_bits(y, _composed(x, 1, True, 2))
    assert conv.reflect_pad_hw.launches == before
    assert conv.reflect_pad_hw(x, 0) is x


@pytest.mark.parametrize("relu, upsample", [(False, 1), (True, 1), (True, 2)])
def test_gradient_route_is_autograds(monkeypatch, relu, upsample):
    """An input that needs a gradient takes torch.relu, F.interpolate and
    F.pad under autograd: the same output, and F.pad's gradient."""
    monkeypatch.setattr(conv, "reflect_pad_reference",
                        lambda *a, **k: pytest.fail("plain version under autograd"))
    x = _activation((2, 8, 5, 6), torch.float32, seed=1).requires_grad_()
    x_ref = x.detach().clone().requires_grad_()
    y = conv.reflect_pad_hw(x, 2, relu=relu, upsample=upsample)
    want = _composed(x_ref, 2, relu, upsample)
    assert _same_bits(y.detach(), want.detach())
    g = torch.randn(y.shape).contiguous(memory_format=torch.channels_last)
    y.backward(g)
    want.backward(g)
    assert _same_bits(x.grad, x_ref.grad)


def test_other_devices_go_to_the_kernel_never_to_fpad(monkeypatch):
    """A tensor that needs no gradient and is not on the CPU reaches the
    kernel's wrapper, which refuses any device but CUDA: no F.pad."""
    monkeypatch.setattr(F, "pad", lambda *a, **k: pytest.fail("F.pad reached"))
    x = torch.zeros((1, 8, 4, 4), device="meta")
    with pytest.raises(ValueError, match="runs on cuda, not meta"):
        conv.reflect_pad_hw(x, 1)
    calls = []
    monkeypatch.setattr(conv, "reflect_pad",
                        lambda x, pad, **k: calls.append((pad, k)) or x)
    before = conv.reflect_pad_hw.launches
    conv.reflect_conv2d(x, torch.zeros((4, 8, 3, 3), device="meta"), None,
                        relu=True, upsample=2)
    assert calls == [(1, {"relu": True, "upsample": 2})]
    assert conv.reflect_pad_hw.launches == before + 1


def _decoder_unfolded(dec: AdaINDecoder, feat, precision):
    """The AdaIN decoder as the port computed it before the fold."""
    x = feat.permute(0, 3, 1, 2).to(precision.compute_dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    last = len(_DECODER_CFG) - 1
    for i, ((_, up), c) in enumerate(zip(_DECODER_CFG, dec.convs())):
        if up:
            x = F.interpolate(x, scale_factor=2, mode="nearest")
            x = x.contiguous(memory_format=torch.channels_last)
        x = _composed(x, 1)
        x = F.conv2d(x, c.weight.to(x.dtype), c.bias.to(x.dtype))
        if i != last:
            x = torch.relu(x)
    return x.permute(0, 2, 3, 1)


@pytest.mark.parametrize("precision", [Precision.f32(), Precision.bf16()], ids=["f32", "bf16"])
def test_adain_decoder_fold_matches_unfolded(precision):
    torch.manual_seed(0)
    dec = AdaINDecoder().eval()
    feat = torch.from_numpy(
        np.random.default_rng(0).standard_normal((2, 3, 4, 512)).astype(np.float32))
    with torch.no_grad():
        got = dec(feat, precision=precision)
        want = _decoder_unfolded(dec, feat, precision)
    assert got.shape == (2, 24, 32, 3) and got.dtype == precision.compute_dtype
    assert _same_bits(got, want)


def test_build_lists_every_kernel_source():
    on_disk = sorted(p.stem for p in (PORT_DIR / "csrc").glob("*.cu"))
    assert sorted(_build.SOURCES) == on_disk
    assert "reflect_pad" in on_disk


# (C, H, W, pad, relu, upsample) of every reflect pad of the serving cells:
# stylenet at 512^2 and 256^2 (conv1, conv2, the res blocks, final_conv) and
# the AdaIN decoder at 512^2 (AdaIN and StyTr²: input, then each conv's
# pre-ReLU output)
STYLENET_SITES = [(3, 512, 512, 4, False, 1), (64, 256, 256, 1, False, 1),
                  (256, 128, 128, 1, False, 1), (32, 512, 512, 4, False, 1)]
STYLENET_256_SITES = [(3, 256, 256, 4, False, 1), (64, 128, 128, 1, False, 1),
                      (256, 64, 64, 1, False, 1), (32, 256, 256, 4, False, 1)]
DECODER_SITES = [(512, 64, 64, 1, False, 1), (256, 64, 64, 1, True, 2),
                 (256, 128, 128, 1, True, 1), (128, 128, 128, 1, True, 2),
                 (128, 256, 256, 1, True, 1), (64, 256, 256, 1, True, 2),
                 (64, 512, 512, 1, True, 1)]
SITES = STYLENET_SITES + STYLENET_256_SITES + DECODER_SITES
SMS, BLOCKS_PER_SM = 132, 2048 // 256  # an H100's SMs; 256-thread blocks an SM holds


def test_plans_at_the_serving_sites():
    """16-byte words at every site; the pixel route but at RGB; at B=8 and
    512^2 the grid is at least two waves of the card."""
    for c, h, w, pad, _, up in SITES:
        for itemsize in (2, 4):
            plan = cuda_pad.plan_pad(8, c, h, w, itemsize, pad, up, x_ptr=256)
            assert plan.vec == 16
            assert plan.route == ("gather" if c == 3 else "pixel")
            assert plan.segs * plan.seg_words >= plan.row_words
            assert plan.seg_words <= 1024 and (plan.segs - 1) * plan.seg_words < plan.row_words
    for c, h, w, pad, _, up in STYLENET_SITES + DECODER_SITES:
        plan = cuda_pad.plan_pad(8, c, h, w, 2, pad, up, x_ptr=256)
        assert plan.rows * plan.segs >= 2 * SMS * BLOCKS_PER_SM, (c, h, w)


def test_plans_narrow_the_word_where_the_row_needs_it():
    # 3 bf16 channels, 7 + 2 columns: 54-byte rows, 2-byte words, each in a pixel
    assert cuda_pad.plan_pad(1, 3, 5, 7, 2, 1, 1, 256)[:2] == ("pixel", 2)
    # 3 f32 channels, 6 + 2 columns: 96-byte rows, 16-byte words across pixels
    assert cuda_pad.plan_pad(1, 3, 5, 6, 4, 1, 1, 256)[:2] == ("gather", 16)
    # 4 bf16 channels (8 bytes a pixel), 10 columns: 16-byte words straddle pixels
    assert cuda_pad.plan_pad(1, 4, 8, 8, 2, 1, 1, 256)[:2] == ("gather", 16)
    # x aligned to 8 bytes only: element loads
    assert cuda_pad.plan_pad(1, 64, 8, 8, 2, 1, 1, 264)[:2] == ("gather", 16)
    assert cuda_pad.plan_pad(1, 12, 8, 8, 4, 1, 1, 256)[:2] == ("pixel", 16)
    assert cuda_pad.plan_pad(1, 6, 8, 9, 4, 1, 1, 256)[:2] == ("pixel", 8)


def test_kernel_wrapper_refuses_what_the_kernel_cannot_take():
    """The checks before a launch: layout, dtype, pad and an empty tensor."""
    x = _activation((2, 64, 8, 8), torch.bfloat16, seed=0)
    cuda_pad._check(x, 1, 2)
    with pytest.raises(ValueError, match="channels_last"):
        cuda_pad._check(x.contiguous(), 1, 1)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        cuda_pad._check(x.half(), 1, 1)
    with pytest.raises(ValueError, match="reflect padding 8"):
        cuda_pad._check(x, 8, 1)
    with pytest.raises(ValueError, match="empty"):
        cuda_pad._check(x[:0], 1, 1)


def test_int8_pad_shares_the_kernels_index_map():
    """The int8 path gathers its padded codes by the same source index."""
    from fast_neural_style_transfer_tpu_torch.infer.quantized import _reflect_pad

    xq = torch.arange(2 * 3 * 5 * 6, dtype=torch.int8).reshape(2, 3, 5, 6)
    want = F.pad(xq.float(), (2, 2, 2, 2), mode="reflect").to(torch.int8).permute(0, 2, 3, 1)
    assert torch.equal(_reflect_pad(xq, 2), want)
    with pytest.raises(ValueError, match="reflect padding 5"):
        _reflect_pad(xq, 5)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.gpu
def test_kernel_bit_equal_at_every_serving_site_on_card():
    """bf16 at B=1 and 8, f32 at B=1 (the f32 and int8-calibration paths):
    the kernel equals its plain version and F.pad's composition bit for
    bit, -0 in the input."""
    _card()
    with torch.inference_mode():
        for i, (c, h, w, pad, relu, up) in enumerate(SITES):
            for n, dtype in ((1, torch.bfloat16), (8, torch.bfloat16), (1, torch.float32)):
                x = _activation((n, c, h, w), dtype, seed=i, device="cuda")
                before = conv.reflect_pad_hw.launches
                got = conv.reflect_pad_hw(x, pad, relu=relu, upsample=up)
                assert conv.reflect_pad_hw.launches == before + 1
                torch.cuda.synchronize()
                assert got.is_contiguous(memory_format=torch.channels_last)
                case = (c, h, w, pad, relu, up, n, dtype)
                assert _same_bits(got, cuda_pad.reflect_pad_reference(
                    x, pad, relu=relu, upsample=up)), case
                assert _same_bits(got, _composed(x, pad, relu, up)), case


@pytest.mark.gpu
def test_kernel_bit_equal_at_odd_shapes_on_card():
    """The narrow words and the gather route: odd sides, 3 and 4 channels,
    an x aligned to 2 bytes only, NaN and -0, each dtype."""
    _card()
    with torch.inference_mode():
        for dtype in (torch.bfloat16, torch.float32):
            for c, h, w, pad, up in [(3, 5, 7, 1, 1), (3, 9, 11, 4, 1), (4, 8, 8, 1, 1),
                                     (5, 6, 7, 2, 2), (64, 3, 3, 2, 1), (12, 7, 5, 3, 2)]:
                for relu in (False, True):
                    x = _activation((2, c, h, w), dtype, seed=c, device="cuda")
                    x[0, 0, 0, 1] = float("nan")
                    got = conv.reflect_pad_hw(x, pad, relu=relu, upsample=up)
                    want = _composed(x, pad, relu, up)
                    assert _same_bits(got, want), (c, h, w, pad, up, relu, dtype)
            # a view one element into its storage: not 16-byte aligned
            base = torch.randn(64 * 8 * 8 + 1, device="cuda").to(dtype)
            x = base[1:].view(1, 8, 8, 64).permute(0, 3, 1, 2)
            assert cuda_pad.plan_pad(1, 64, 8, 8, x.element_size(), 1, 1,
                                    x.data_ptr()).route == "gather"
            assert _same_bits(conv.reflect_pad_hw(x, 1, relu=True), _composed(x, 1, True))


def _u8_batch(n, side, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, side, side, 3), np.uint8)


def _he_decoder(sd, prefix=""):
    """The AdaIN decoder's convs He-normal, the last scaled down and its bias
    mid-range, so that the u8 output spreads (PyTorch's default init leaves
    it all but constant)."""
    sd = dict(sd)
    convs = sorted((k for k in sd if k.startswith(prefix) and k.endswith("weight")
                    and sd[k].dim() == 4 and k.count(".") == prefix.count(".") + 1),
                   key=lambda k: int(k[len(prefix):].split(".")[0]))
    for k in convs:
        sd[k] = torch.randn(sd[k].shape) * (2.0 / sd[k][0].numel()) ** 0.5
    sd[convs[-1]] *= 0.2
    sd[convs[-1][:-len("weight")] + "bias"] = torch.full_like(sd[convs[-1][:-len("weight")] + "bias"], 0.5)
    return sd


def _stylizers():
    """(name, stylize_u8, reflect pads a forward) of the three serving
    stylizers at bf16, seeded, each on its eager path (no CUDA graphs: a
    replay would not take a monkeypatched pad)."""
    from fast_neural_style_transfer_tpu_torch.infer.adain import ArbitraryStylizer
    from fast_neural_style_transfer_tpu_torch.infer.stylize import Stylizer
    from fast_neural_style_transfer_tpu_torch.infer.stytr2 import TransformerStylizer
    from fast_neural_style_transfer_tpu_torch.models import TransformerNet
    from fast_neural_style_transfer_tpu_torch.models.stytr2 import StyTr2
    from fast_neural_style_transfer_tpu_torch.models.vgg_weights import random_params

    torch.manual_seed(0)
    net = Stylizer(TransformerNet().state_dict(), precision="bf16", device="cuda")
    ada = ArbitraryStylizer(_he_decoder(AdaINDecoder().state_dict()), random_params(0),
                            precision="bf16", device="cuda")
    ada.set_style_u8(_u8_batch(1, 256, 1)[0])
    net._graphs = ada._graphs = None
    sty = TransformerStylizer(_he_decoder(StyTr2().state_dict(), "decoder."),
                              precision="bf16", device="cuda")
    sty.set_style_u8(_u8_batch(1, 256, 2)[0])
    return [("stylenet", net.stylize_u8, 13), ("adain", ada.stylize_u8, 9),
            ("stytr2", sty.stylize_u8, 9)]


@pytest.mark.gpu
def test_stylizers_launch_the_kernel_and_match_the_fpad_route_on_card(monkeypatch):
    """At B=8 512^2: 13 launches a Stylizer forward, 9 an ArbitraryStylizer
    or TransformerStylizer forward (the decoder's ReLUs and upsamples read
    through), and the u8 outputs those of the F.pad route."""
    _card()
    batch = _u8_batch(8, 512, 3)
    for name, stylize, pads in _stylizers():
        before = conv.reflect_pad_hw.launches
        got = stylize(batch)
        assert conv.reflect_pad_hw.launches - before == pads, name
        with monkeypatch.context() as m:
            m.setattr(conv, "reflect_pad", lambda x, pad, relu=False, upsample=1:
                      _composed(x, pad, relu, upsample))
            want = stylize(batch)
        assert got.shape == batch.shape and got.std() > 0, name
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.gpu
def test_training_step_pads_on_autograd_on_card():
    """A stylizer training step: only conv1's pad, of the image batch,
    which needs no gradient, launches the kernel; the 12 pads of
    activations that need one take autograd's route."""
    _card()
    from fast_neural_style_transfer_tpu_torch.losses import LossTaps, style_targets_from_features
    from fast_neural_style_transfer_tpu_torch.models import TransformerNet
    from fast_neural_style_transfer_tpu_torch.models.vgg_weights import make_vgg, random_params
    from fast_neural_style_transfer_tpu_torch.train.state import create_train_state
    from fast_neural_style_transfer_tpu_torch.train.step import make_train_step
    from fast_neural_style_transfer_tpu_torch.utils.image_io import u8_to_network

    torch.manual_seed(0)
    net = TransformerNet().to("cuda", memory_format=torch.channels_last)
    vgg = make_vgg(random_params(0), "cuda")
    u8 = torch.from_numpy(_u8_batch(4, 128, 4)).to("cuda")
    with torch.no_grad():
        grams = style_targets_from_features(
            vgg(u8_to_network(torch.from_numpy(_u8_batch(1, 128, 5)).to("cuda")),
                LossTaps().style_taps))
    step = make_train_step(dropout=False)
    state = create_train_state(net)
    before = conv.reflect_pad_hw.launches
    metrics = step(state, vgg, u8, grams)
    torch.cuda.synchronize()
    assert conv.reflect_pad_hw.launches - before == 1
    assert np.isfinite(float(metrics["loss"]))
