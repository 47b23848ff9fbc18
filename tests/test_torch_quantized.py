"""The port's int8 inference against the JAX package's, on the CPU.

Same weights on both sides (JAX ``init`` from a seed, carried across by
``params_from_jax``), inputs from numpy seeds.

Bounds:
- ``quantize_params``: bit-equal codes, scales, biases and affines (the same
  f32 max, division, round-half-even and clip);
- ``apply_int8`` on (2, 64, 64, 3): the first conv's int8 codes exactly
  (its input is the same f32 tensor on both sides); the output of the
  in-repo trained checkpoint within 1e-2 relative L2 of the JAX package's;
  on a random-weight net, within twice the JAX package's own spread between
  its jitted and eager int8 forwards (later layers' float inputs differ by
  f32 roundoff, which moves a code where a value lands on a rounding
  boundary, and a random net amplifies it);
- ``calibrate``: scales within 1e-6 relative (f32 float forwards in other
  summation orders);
- int8 against the f32 forward: the JAX package's own bounds, relative L2
  < 0.15 and correlation > 0.98 (a random-weight net, the worst case);
- ``Stylizer(precision="int8")`` against the JAX int8 Stylizer on the
  trained checkpoint: u8 mean |delta| <= 0.5.
"""

import argparse
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from PIL import Image

from fast_neural_style_transfer_tpu.infer import quantized as jq
from fast_neural_style_transfer_tpu.infer.stylize import Stylizer as JaxStylizer
from fast_neural_style_transfer_tpu.models.transformer import TransformerNet as JaxNet
from fast_neural_style_transfer_tpu_torch.cli import begin_inference
from fast_neural_style_transfer_tpu_torch.infer import Stylizer
from fast_neural_style_transfer_tpu_torch.infer import quantized as q
from fast_neural_style_transfer_tpu_torch.infer.video import VideoStylizer
from fast_neural_style_transfer_tpu_torch.models import (
    TransformerNet,
    load_checkpoint,
    params_from_jax,
)
from fast_neural_style_transfer_tpu_torch.serve import http as serve_http

CHECKPOINT = Path(__file__).resolve().parents[1] / "evidence" / "soak40k_r5" / \
    "style_transfer_final.pth"


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)  # the suite runs with several xdist workers
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def net():
    jp = jax.tree.map(np.asarray, JaxNet.init(jax.random.PRNGKey(11)))
    return {"jax": jp, "port": params_from_jax(jp)}


@pytest.fixture(scope="module")
def trained():
    """The in-repo trained single-style checkpoint, as each package loads it."""
    return {"jax": JaxStylizer.load_params(str(CHECKPOINT)),
            "port": load_checkpoint(str(CHECKPOINT))}


@pytest.fixture(scope="module")
def x64():
    return np.random.default_rng(0).standard_normal((2, 64, 64, 3)).astype(np.float32)


_CONV_PERM = {False: (2, 3, 1, 0), True: (2, 3, 0, 1)}  # OIHW / IOHW -> HWIO


def test_quantize_params_bit_equal_to_jax(net):
    ours = q.quantize_params(net["port"])
    theirs = jq.quantize_params(net["jax"])
    for name, _, transposed in q._CONVS:
        a, b = q._get(ours, name), q._get(theirs, name)
        np.testing.assert_array_equal(
            a["wq"].numpy().transpose(_CONV_PERM[transposed]), np.asarray(b["wq"]))
        for k in ("scale", "b"):
            assert a[k].numpy().tobytes() == np.asarray(b[k]).tobytes(), (name, k)
    for name in q._NORMS:
        a, b = q._get(ours, name), q._get(theirs, name)
        for k in ("gamma", "beta"):
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))


def test_int8_conv_primitives_are_exact(net):
    """The _int_mm convs against float convs of the same int8 codes (every
    product and sum exact in f32 at these sizes): reflect conv at stride 2
    (conv1, K padded 243 -> 248), ConvTranspose (up1), final_conv (N padded
    3 -> 8), and an image small enough to need padded rows."""
    qp = q.quantize_params(net["port"])
    rng = np.random.default_rng(1)
    cases = [("conv1", (1, 3, 20, 24), 2), ("up1", (2, 256, 5, 6), None),
             ("final_conv", (1, 32, 12, 8), 1), ("conv2", (1, 64, 4, 4), 2)]
    for name, shape, stride in cases:
        p = q._get(qp, name)
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        x = x.contiguous(memory_format=torch.channels_last)
        xq, sx = q._quantize_act(x)
        w = p["wq"].float()
        if stride is None:
            y = q._qconv_transpose(p, x)
            ref = F.conv_transpose2d(xq.float(), w, None, stride=2, padding=1, output_padding=1)
        else:
            y = q._qreflect_conv(p, x, stride=stride)
            k = w.shape[-1] // 2
            ref = F.conv2d(F.pad(xq.float(), (k, k, k, k), mode="reflect"), w, None,
                           stride=stride)
        want = ref * (sx * p["scale"])[None, :, None, None] + p["b"][None, :, None, None]
        assert y.is_contiguous(memory_format=torch.channels_last), name
        torch.testing.assert_close(y, want, rtol=0, atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("weights", ["trained", "random"])
def test_apply_int8_matches_jax(net, trained, x64, weights):
    """The trained checkpoint within 1e-2 relative L2. A random-weight net
    is chaotic under requantization: one code flipped by f32 roundoff in an
    early res block spreads through the later ones, and the JAX package's
    own jitted and eager int8 forwards differ at the percent level there;
    the port is held to twice that spread, measured here."""
    params = trained if weights == "trained" else net
    ours_q, theirs_q = q.quantize_params(params["port"]), jq.quantize_params(params["jax"])
    # the first conv's int8 codes: the same f32 input on both sides
    xq, _ = q._quantize_act(torch.from_numpy(x64).permute(0, 3, 1, 2))
    jxq, _ = jq._quantize_act(jnp.asarray(x64))
    np.testing.assert_array_equal(xq.permute(0, 2, 3, 1).numpy(), np.asarray(jxq))
    # the first layer's dequantized output, which both compute from those codes
    a = q._qreflect_conv(q._get(ours_q, "conv1"),
                         torch.from_numpy(x64).permute(0, 3, 1, 2), stride=2)
    b = jq._qreflect_conv(jq._get_conv(theirs_q, "conv1"), jnp.asarray(x64), stride=2)
    np.testing.assert_allclose(a.permute(0, 2, 3, 1).numpy(), np.asarray(b), rtol=1e-5,
                               atol=1e-5)
    got = q.apply_int8(ours_q, torch.from_numpy(x64)).numpy()
    want = np.asarray(jax.jit(jq.apply_int8)(theirs_q, jnp.asarray(x64)))
    assert got.shape == want.shape == x64.shape
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    if weights == "trained":
        assert rel <= 1e-2, rel
    else:
        with jax.disable_jit():
            eager = np.asarray(jq.apply_int8(theirs_q, jnp.asarray(x64)))
        spread = np.linalg.norm(eager - want) / np.linalg.norm(want)
        assert rel <= 2 * spread, (rel, spread)


def test_calibrate_matches_jax(net, x64):
    ours = q.calibrate(q.quantize_params(net["port"]), net["port"], x64)
    theirs = jq.calibrate(jq.quantize_params(net["jax"]), net["jax"], jnp.asarray(x64))
    for name in q._CONV_ORDER:
        a = float(q._get(ours, name)["act_scale"])
        b = float(jq._get_conv(theirs, name)["act_scale"])
        assert abs(a - b) <= 1e-6 * abs(b), (name, a, b)
    assert "act_scale" not in q._get(q.quantize_params(net["port"]), "conv1")


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "calibrated"])
def test_int8_tracks_f32(net, x64, static):
    qp = q.quantize_params(net["port"])
    x = x64
    if static:  # scales from one batch, applied to another
        qp = q.calibrate(qp, net["port"], x64)
        x = np.random.default_rng(7).standard_normal(x64.shape).astype(np.float32)
    module = TransformerNet().eval()
    module.load_state_dict(net["port"])
    with torch.no_grad():
        ref = module(torch.from_numpy(x)).numpy()
        got = q.apply_int8(qp, torch.from_numpy(x)).numpy()
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    corr = np.corrcoef(got.ravel(), ref.ravel())[0, 1]
    assert rel < 0.15 and corr > 0.98, (rel, corr)


def test_int8_stylizer_matches_jax(trained):
    img = np.random.default_rng(3).integers(0, 256, (2, 40, 56, 3), dtype=np.uint8)
    got = Stylizer(trained["port"], precision="int8", device="cpu").stylize_u8(img)
    want = JaxStylizer(trained["jax"], precision="int8").stylize_u8(img)
    assert got.shape == want.shape == img.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).mean() <= 0.5


def test_int8_stylizer_counts_and_refusals(net, monkeypatch):
    """The int8 Stylizer runs the IN wrapper at 14 sites a forward, with
    (C,) affines and ReLU where the walk has it; the video path, whose
    frozen statistics need the float net, refuses int8 as the JAX package's
    does."""
    calls = []
    real = q.instance_norm

    def spy(x, gamma, beta, **kw):
        calls.append((tuple(gamma.shape), kw["relu"]))
        return real(x, gamma, beta, **kw)

    monkeypatch.setattr(q, "instance_norm", spy)
    sty = Stylizer(net["port"], precision="int8", device="cpu")
    assert sty.net is None and sty.qparams["conv1"]["wmat"].shape == (64, 248)
    sty.stylize_u8(np.zeros((1, 32, 32, 3), np.uint8))
    assert len(calls) == 14 and sum(r for _, r in calls) == 9
    with pytest.raises(ValueError, match="unknown precision"):
        VideoStylizer(net["port"], precision="int8", device="cpu")
    with pytest.raises(ValueError, match="unknown norm_method"):
        q.apply_int8(sty.qparams, torch.zeros(1, 8, 8, 3), norm_method="pallas")


def test_begin_inference_int8_cli(net, tmp_path, capsys):
    ckpt = str(tmp_path / "m.pth")
    torch.save(net["port"], ckpt)
    src = str(tmp_path / "in.png")
    img = np.random.default_rng(4).integers(0, 256, (24, 28, 3), dtype=np.uint8)
    Image.fromarray(img).save(src)
    begin_inference.main(["--model_path", ckpt, "--content_image", src, "--output_dir",
                          str(tmp_path / "o"), "--device", "cpu", "--output_name", "x.png",
                          "--precision", "int8"])
    assert "saved" in capsys.readouterr().out
    got = np.asarray(Image.open(tmp_path / "o" / "x.png"))
    want = Stylizer(net["port"], precision="int8", device="cpu").stylize_u8(img)
    np.testing.assert_array_equal(got, want)


def serve_http_args(**kw):
    """The flags ``serve/http.py::_build_forward`` reads."""
    base = dict(adain_decoder=None, style=None, model=None, style_index=None,
                precision="bf16", preserve_color="off", alpha=1.0, vgg_weights=None,
                data_parallel=False)
    base.update(kw)
    return argparse.Namespace(**base)


def test_serve_int8_flagship_only(tmp_path):
    ckpt = str(tmp_path / "m.pth")
    torch.save(TransformerNet().state_dict(), ckpt)
    with pytest.raises(SystemExit, match="flagship family only"):
        serve_http.main(["--model", ckpt, "--cpu", "--adain-decoder", "d.npz", "--style",
                         "s.jpg", "--precision", "int8"])
    forward, family, device = serve_http._build_forward(
        serve_http_args(model=ckpt, precision="int8"), "cpu")
    out = forward(np.zeros((2, 64, 64, 3), np.uint8))
    assert family == "flagship" and out.shape == (2, 64, 64, 3) and out.dtype == np.uint8

