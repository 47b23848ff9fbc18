"""The stylizer's 32 -> 3 9x9 conv kernel of the port (``ops/cuda_conv_rgb.py``)
and its route (``ops/conv.py::reflect_conv2d``), on the CPU.

- The kernel's plain version against the JAX package's reflect conv
  (``fast_neural_style_transfer_tpu/ops/conv.py``, the direct lowering) at
  the final conv's shape, for several batches and odd, ragged and strip-
  straddling sides: in float32 at 1e-4 (XLA and PyTorch sum the 2592
  products in other orders), and in bf16 within one rounding step.
- The route's table: only a bf16 channels_last CUDA input that needs no
  gradient, at the (3, 32, 9, 9) weight, stride 1, no ReLU and no upsample,
  goes to the kernel.
- ``reflect_conv2d`` hands the kernel the padded input and the operands in
  x's dtype; a CPU call launches nothing; the wrapper refuses what the
  kernel cannot take; the planner's grids; the build's source group.
- ``TransformerNet`` on the CPU gives the outputs of the route before the
  kernel, bit for bit, and with the route forced onto the plain version
  within a bf16 rounding step.

The kernel itself runs only on a card: ``tests/test_torch_package.py``'s
``gpu`` tests and ``chip_smoke.py --phases conv_to_rgb`` hold it to the
plain version there.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fast_neural_style_transfer_tpu.ops import conv as jconv
from fast_neural_style_transfer_tpu_torch.core.dtypes import Precision
from fast_neural_style_transfer_tpu_torch.models import TransformerNet
from fast_neural_style_transfer_tpu_torch.models.transformer import layer_walk
from fast_neural_style_transfer_tpu_torch.ops import _build, conv, cuda_conv_rgb, cuda_pad

SMS = 132  # an H100's SMs


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs with several xdist workers
    yield
    torch.set_num_threads(prev)


def _bf16_exact(a: np.ndarray) -> np.ndarray:
    """a rounded to bf16 and back: operands both sides take exactly."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _operands(n, h, w, seed):
    """NHWC post-ReLU activations (about half zeros), HWIO weights of the
    default init's scale and a bias, all bf16-representable."""
    rng = np.random.default_rng(seed)
    x = _bf16_exact(np.maximum(rng.standard_normal((n, h, w, 32)), 0).astype(np.float32))
    wt = _bf16_exact((rng.standard_normal((9, 9, 32, 3)) * 0.02).astype(np.float32))
    b = _bf16_exact((rng.standard_normal(3) * 0.1).astype(np.float32))
    return x, wt, b


def _nchw(a: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(a).to(dtype).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def _oihw(wt: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(wt.transpose(3, 2, 0, 1)))


SHAPES = [(1, 5, 5), (2, 7, 13), (3, 16, 9), (1, 9, 121), (2, 12, 130)]


@pytest.mark.parametrize("n, h, w", SHAPES)
def test_plain_matches_jax_f32(n, h, w):
    x, wt, b = _operands(n, h, w, seed=h * w)
    want = jconv.reflect_conv2d(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b),
                                lowering="direct")
    xp = cuda_pad.reflect_pad_reference(_nchw(x), 4)
    got = cuda_conv_rgb.conv_to_rgb_reference(xp, _oihw(wt), torch.from_numpy(b))
    assert got.shape == (n, 3, h, w) and got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n, h, w", SHAPES)
def test_plain_matches_jax_bf16_within_a_rounding_step(n, h, w):
    """bf16 operands, the output rounded once: at most one bf16 step from
    JAX's float32 result of the same operands."""
    x, wt, b = _operands(n, h, w, seed=h + w)
    want = np.asarray(jconv.reflect_conv2d(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b),
                                           lowering="direct"))
    xp = cuda_pad.reflect_pad_reference(_nchw(x, torch.bfloat16), 4)
    got = cuda_conv_rgb.conv_to_rgb_reference(xp, _oihw(wt).bfloat16(),
                                              torch.from_numpy(b).bfloat16())
    assert got.dtype == torch.bfloat16
    got = got.float().permute(0, 2, 3, 1).numpy()
    assert np.all(np.abs(got - want) <= 2.0 ** -8 * np.abs(want) + 1e-6)


def _fake_x(device="cuda", dtype=torch.bfloat16, requires_grad=False, channels_last=True):
    """What ``takes_rgb`` reads of an input, without a card."""
    return types.SimpleNamespace(
        device=torch.device(device), dtype=dtype, requires_grad=requires_grad,
        dim=lambda: 4, is_contiguous=lambda memory_format=None: channels_last)


FINAL = torch.zeros(3, 32, 9, 9)


@pytest.mark.parametrize("x, weight, kw, grad, engaged", [
    (_fake_x(), FINAL, {}, True, True),  # no tensor needs a gradient
    (_fake_x(), FINAL, {}, False, True),
    (_fake_x(requires_grad=True), FINAL, {}, False, True),  # under no_grad
    (_fake_x(requires_grad=True), FINAL, {}, True, False),  # training
    (_fake_x(), FINAL.clone().requires_grad_(), {}, True, False),
    (_fake_x(dtype=torch.float32), FINAL, {}, False, False),  # f32, int8 calibration
    (_fake_x(dtype=torch.float16), FINAL, {}, False, False),
    (_fake_x(device="cpu"), FINAL, {}, False, False),
    (_fake_x(device="meta"), FINAL, {}, False, False),
    (_fake_x(channels_last=False), FINAL, {}, False, False),
    (_fake_x(), torch.zeros(3, 64, 3, 3), {}, False, False),  # the decoders' RGB convs
    (_fake_x(), torch.zeros(64, 3, 9, 9), {}, False, False),  # conv1
    (_fake_x(), torch.zeros(3, 32, 3, 3), {}, False, False),
    (_fake_x(), FINAL, {"stride": 2}, False, False),
    (_fake_x(), FINAL, {"relu": True}, False, False),
    (_fake_x(), FINAL, {"upsample": 2}, False, False),
], ids=["grad-mode", "nograd", "x-grad-nograd", "x-grad", "w-grad", "f32", "f16", "cpu",
        "meta", "nchw", "64to3-k3", "conv1", "k3", "stride2", "relu", "upsample"])
def test_route_table(x, weight, kw, grad, engaged):
    with torch.set_grad_enabled(grad):
        assert cuda_conv_rgb.takes_rgb(x, weight, torch.zeros(3), **kw) is engaged
        if engaged:
            assert cuda_conv_rgb.takes_rgb(x, weight, None, **kw)
    if not weight.requires_grad:
        bias = torch.zeros(3, requires_grad=True)
        with torch.enable_grad():
            assert not cuda_conv_rgb.takes_rgb(x, weight, bias, **kw)


def test_route_hands_the_kernel_the_padded_input_in_xs_dtype(monkeypatch):
    """Where the route engages, ``reflect_conv2d`` pads x by 4 (the pad's own
    route) and calls ``conv_to_rgb`` with the weight and bias cast to x's
    dtype, weight strides kept; F.conv2d is not reached."""
    calls = []
    monkeypatch.setattr(conv, "takes_rgb", lambda *a, **k: True)
    monkeypatch.setattr(conv, "conv_to_rgb", lambda xp, w, b: calls.append((xp, w, b)) or "y")
    monkeypatch.setattr(F, "conv2d", lambda *a, **k: pytest.fail("F.conv2d reached"))
    x = _nchw(_operands(2, 6, 7, seed=0)[0], torch.bfloat16)
    w = torch.randn(3, 32, 9, 9).contiguous(memory_format=torch.channels_last)
    b = torch.randn(3)
    with torch.no_grad():
        assert conv.reflect_conv2d(x, w, b) == "y"
    (xp, wc, bc), = calls
    assert xp.shape == (2, 32, 14, 15) and torch.equal(xp, cuda_pad.reflect_pad_reference(x, 4))
    assert wc.dtype == bc.dtype == torch.bfloat16 and wc.stride() == w.stride()
    assert torch.equal(wc, w.bfloat16()) and torch.equal(bc, b.bfloat16())


def test_cpu_launches_nothing():
    x, wt, b = _operands(1, 8, 8, seed=1)
    before = cuda_conv_rgb.conv_to_rgb.launches
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            y = conv.reflect_conv2d(_nchw(x, dtype), _oihw(wt), torch.from_numpy(b))
            assert y.shape == (1, 3, 8, 8) and y.dtype == dtype
            xp = cuda_pad.reflect_pad_reference(_nchw(x, dtype), 4)
            y = cuda_conv_rgb.conv_to_rgb(xp, _oihw(wt).to(dtype), torch.from_numpy(b).to(dtype))
            assert torch.equal(y, cuda_conv_rgb.conv_to_rgb_reference(
                xp, _oihw(wt).to(dtype), torch.from_numpy(b).to(dtype)))
    assert cuda_conv_rgb.conv_to_rgb.launches == before
    assert cuda_conv_rgb.conv_to_rgb in _build.COUNTED


def test_wrapper_refuses_what_the_kernel_cannot_take():
    bf = torch.bfloat16
    xp = torch.zeros(2, 32, 16, 16, dtype=bf).contiguous(memory_format=torch.channels_last)
    w, b = torch.zeros(3, 32, 9, 9, dtype=bf), torch.zeros(3, dtype=bf)
    cuda_conv_rgb._check(xp, w, b)
    cuda_conv_rgb._check(xp, w, None)
    with pytest.raises(ValueError, match="runs on cuda, not meta"):
        cuda_conv_rgb.conv_to_rgb(xp.to("meta"), w.to("meta"), b.to("meta"))
    with pytest.raises(TypeError, match="bfloat16"):
        cuda_conv_rgb._check(xp.float(), w, b)
    with pytest.raises(TypeError, match="bfloat16"):
        cuda_conv_rgb._check(xp, w, b.float())
    with pytest.raises(ValueError, match="channels_last"):
        cuda_conv_rgb._check(xp.contiguous(), w, b)
    with pytest.raises(ValueError, match="channels_last, 16-byte aligned"):
        base = torch.zeros(2 * 16 * 16 * 32 + 1, dtype=bf)
        cuda_conv_rgb._check(base[1:].view(2, 16, 16, 32).permute(0, 3, 1, 2), w, b)
    with pytest.raises(ValueError, match=r"\(3, 32, 9, 9\) weight"):
        cuda_conv_rgb._check(xp, torch.zeros(3, 32, 3, 3, dtype=bf), b)
    with pytest.raises(ValueError, match=r"\(3,\) bias"):
        cuda_conv_rgb._check(xp, w, torch.zeros(4, dtype=bf))
    with pytest.raises(ValueError, match="N, 32"):
        cuda_conv_rgb._check(xp[:, :16], w, b)
    with pytest.raises(ValueError, match="5 x 5 or more"):
        cuda_conv_rgb._check(xp[:, :, :12], w, b)


@pytest.mark.parametrize("n, h, w", [(8, 512, 512), (1, 256, 256), (2, 256, 256),
                                     (1, 260, 388), (8, 256, 256), (3, 5, 5), (1, 7, 1000)])
def test_plans_cover_the_output(n, h, w):
    """Even strips of at most STRIP columns; at most one block an SM, each
    an equal run of the rows of all (image, strip) columns."""
    plan = cuda_conv_rgb.plan_rgb(n, h, w, SMS)
    assert plan.strips * cuda_conv_rgb.STRIP >= w > (plan.strips - 1) * cuda_conv_rgb.STRIP
    assert plan.strip <= cuda_conv_rgb.STRIP
    assert plan.strips * plan.strip >= w > (plan.strips - 1) * plan.strip
    total = n * plan.strips * h
    assert plan.blocks <= SMS and plan.blocks * plan.rows >= total
    assert (plan.blocks - 1) * plan.rows < total


def test_plan_at_the_bulk_shape_fills_the_card():
    """B=8 512^2: five strips of 103 columns (seven warps of a block at work
    in each), 20480 rows of columns in 132 runs of 156, one a block: every
    SM busy, a run crossing at most one column's end."""
    plan = cuda_conv_rgb.plan_rgb(8, 512, 512, SMS)
    assert (plan.strips, plan.strip, plan.rows, plan.blocks) == (5, 103, 156, 132)
    small = cuda_conv_rgb.plan_rgb(1, 256, 256, SMS)
    assert (small.strips, small.rows, small.blocks) == (3, 6, 128)
    assert cuda_conv_rgb.plan_rgb(1, 5, 5, SMS) == (1, 5, 1, 5)


def test_the_kernel_builds_with_the_stylizers_kernels():
    assert "conv_to_rgb" in _build.TOGETHER


def _net(seed=0):
    torch.manual_seed(seed)
    net = TransformerNet().eval()
    with torch.no_grad():  # a spread output: the default init leaves it near 0
        net.final_conv.conv.weight.mul_(5.0)
    return net


def _u8_input(n, h, w, seed):
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        0, 255, (n, h, w, 3)).astype(np.float32))


@pytest.mark.parametrize("precision", [Precision.f32(), Precision.bf16()], ids=["f32", "bf16"])
def test_transformer_net_on_the_cpu_gives_the_outputs_of_before(precision):
    """The net's forward on the CPU equals ``layer_walk`` with the convs as
    they ran before the kernel (reflect pad, then F.conv2d), bit for bit,
    and launches nothing."""
    net = _net()
    x = _u8_input(2, 24, 20, seed=2)

    def old_conv(name, v, stride):
        c = net.layers[name]
        v = conv.reflect_pad_hw(v, c.weight.shape[-1] // 2)
        bias = c.bias.to(v.dtype)
        return F.conv2d(v, c.weight.to(v.dtype), bias, stride=stride)

    def up(name, v):
        c = net.layers[name]
        return conv.conv_transpose2d(v, c.weight, c.bias, stride=2, padding=1,
                                     output_padding=1)

    before = cuda_conv_rgb.conv_to_rgb.launches
    with torch.no_grad():
        got = net(x, precision)
        want = layer_walk(
            x.permute(0, 3, 1, 2).to(precision.compute_dtype).contiguous(
                memory_format=torch.channels_last),
            conv=old_conv, up=up, inorm=lambda name, v, relu: net.layers[name](
                v, relu, None, False, None)).permute(0, 2, 3, 1).to(x.dtype)
    assert cuda_conv_rgb.conv_to_rgb.launches == before
    assert got.shape == (2, 24, 20, 3) and got.std() > 0.05
    assert torch.equal(got, want)


def test_transformer_net_with_the_route_forced_onto_the_plain_version(monkeypatch):
    """bf16 with the final conv routed to ``conv_to_rgb`` (its plain version
    on the CPU): once on the final conv, and within a bf16 rounding step of
    the cuDNN route's output on outputs of order 1."""
    net = _net(1)
    x = _u8_input(2, 16, 24, seed=3)
    with torch.no_grad():
        want = net(x, Precision.bf16()).float()
        seen = []
        real = cuda_conv_rgb.takes_rgb

        def forced(v, weight, bias, **kw):
            hit = tuple(weight.shape) == cuda_conv_rgb.WEIGHT_SHAPE and v.dtype == torch.bfloat16
            seen.append(hit)
            return hit or real(v, weight, bias, **kw)

        monkeypatch.setattr(conv, "takes_rgb", forced)
        got = net(x, Precision.bf16()).float()
    assert seen.count(True) == 1 and seen[-1]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2.0 ** -7,
                               atol=2.0 ** -7 * float(want.abs().max()))
