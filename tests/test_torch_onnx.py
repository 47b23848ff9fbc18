"""The port's ONNX export and runtime against the JAX package's, on the CPU.

Same weights on both sides (JAX ``init`` from a seed, carried across by
``params_from_jax``, ``decoder_params_from_jax`` and
``vgg_params_from_jax``); inputs from numpy seeds.

- Graphs: with the same weights the port's ModelProto holds the JAX
  package's graph byte for byte (nodes, attributes, value_infos,
  initializers bit for bit); only ``producer_name`` differs.
- Runtime: the port's ``run_model`` on the CPU against the JAX package's
  ``run_model`` on the same bytes, 1e-4 absolute in network space (f32 sums
  in other orders through 14 instance norms, or the VGG and the decoder).
"""

import importlib
import shutil
import subprocess
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from fast_neural_style_transfer_tpu.export import onnx_adain as j_onnx_adain
from fast_neural_style_transfer_tpu.export import onnx_export as j_onnx_export
from fast_neural_style_transfer_tpu.export import onnx_runtime as j_runtime
from fast_neural_style_transfer_tpu.models.transformer import TransformerNet as JaxNet
from fast_neural_style_transfer_tpu.models.vgg import VGG19Features as JaxVGG
from fast_neural_style_transfer_tpu_torch.export import onnx_adain, onnx_export, onnx_runtime
from fast_neural_style_transfer_tpu_torch.export import onnx_writer as ow
from fast_neural_style_transfer_tpu_torch.models import params_from_jax
from fast_neural_style_transfer_tpu_torch.models.adain import decoder_params_from_jax
from fast_neural_style_transfer_tpu_torch.models.transformer import TransformerNet
from fast_neural_style_transfer_tpu_torch.models.vgg_weights import vgg_params_from_jax

jadain = importlib.import_module("fast_neural_style_transfer_tpu.models.adain")

ROOT = Path(__file__).resolve().parents[1]
PROTO = ROOT / "fast_neural_style_transfer_tpu" / "export" / "onnx_subset.proto"
FIXTURES = Path(__file__).resolve().parent / "fixtures"
TOL = 1e-4


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)  # the suite runs with several xdist workers
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def net():
    jp = jax.tree.map(np.asarray, JaxNet.init(jax.random.PRNGKey(3)))
    return {"jax": jp, "port": params_from_jax(jp)}


@pytest.fixture(scope="module")
def adain():
    vgg = jax.tree.map(np.asarray, JaxVGG.init(jax.random.PRNGKey(0)))
    dec = jax.tree.map(np.asarray, jadain.AdaINDecoder.init(jax.random.PRNGKey(1)))
    return {"vgg": vgg, "dec": dec, "tvgg": vgg_params_from_jax(vgg),
            "tdec": decoder_params_from_jax(dec)}


def _same_graph(ours: bytes, theirs: bytes) -> None:
    """The ModelProtos' top-level fields equal but producer_name (field 2)."""
    a = list(onnx_runtime._fields(ours))
    b = list(onnx_runtime._fields(theirs))
    assert [f for f in a if f[0] == 2] == [(2, 2, b"fast_neural_style_transfer_tpu_torch")]
    assert [f for f in b if f[0] == 2] == [(2, 2, b"fast_neural_style_transfer_tpu")]
    assert [f for f in a if f[0] != 2] == [f for f in b if f[0] != 2]


@pytest.mark.parametrize("shape", [(1, 3, 256, 256), ("batch", 3, "height", "width"),
                                   (2, 3, 30, 42)], ids=["static", "dynamic", "odd"])
def test_stylizer_graph_equals_jax(net, shape):
    _same_graph(onnx_export.build_onnx_model(net["port"], input_shape=shape),
                j_onnx_export.build_onnx_model(net["jax"], input_shape=shape))


def test_build_accepts_a_module_and_refuses_a_bank(net):
    module = TransformerNet()
    module.load_state_dict(net["port"])
    assert onnx_export.build_onnx_model(module) == onnx_export.build_onnx_model(net["port"])
    multi = TransformerNet(num_styles=2).state_dict()
    with pytest.raises(ValueError, match="bake_style"):
        onnx_export.build_onnx_model(multi)


def _baked(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, 1, 1, 512)).astype(np.float32),
            (rng.random((1, 1, 1, 512)) + 0.5).astype(np.float32))


@pytest.mark.parametrize("kw", [
    {},
    {"alpha": 0.7, "content_shape": (1, 3, 32, 40), "style_shape": (1, 3, 48, 32)},
    {"alpha": "input", "content_shape": (1, 3, "height", "width"),
     "style_shape": (1, 3, "style_h", "style_w")},
    {"baked": True, "content_shape": (2, 3, 32, 32)},
    {"preserve_color": "luma", "alpha": 0.5},
    {"baked": True, "preserve_color": "luma", "content_shape": (1, 3, "h", "w")},
], ids=["two_input", "alpha", "alpha_input", "baked", "luma", "baked_luma"])
def test_adain_graph_equals_jax(adain, kw):
    kw = dict(kw)
    if kw.pop("baked", False):
        kw["baked_style"] = _baked(5)
    _same_graph(onnx_adain.build_adain_onnx(adain["tdec"], adain["tvgg"], **kw),
                j_onnx_adain.build_adain_onnx(adain["dec"], adain["vgg"], **kw))


def test_adain_refusals(adain):
    with pytest.raises(ValueError, match="multiples of 8"):
        onnx_adain.build_adain_onnx(adain["tdec"], adain["tvgg"],
                                    content_shape=(1, 3, 30, 32))
    with pytest.raises(ValueError, match="'off' or 'luma'"):
        onnx_adain.build_adain_onnx(adain["tdec"], adain["tvgg"], preserve_color="match")


@pytest.mark.parametrize("hw", [(32, 32), (20, 28)], ids=["32x32", "20x28"])
def test_run_model_matches_jax_runtime(net, hw):
    data = onnx_export.build_onnx_model(net["port"], input_shape=(2, 3, *hw))
    x = np.random.default_rng(1).standard_normal((2, 3, *hw)).astype(np.float32)
    (got,) = onnx_runtime.run_model(data, {"input_image": x}, device="cpu")
    (want,) = j_runtime.run_model(data, {"input_image": x})
    assert got.shape == want.shape == (2, 3, -(-hw[0] // 4) * 4, -(-hw[1] // 4) * 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    # the same graph parsed the same way
    ours, theirs = onnx_runtime.parse_model(data), j_runtime.parse_model(data)
    assert [n["op"] for n in ours["nodes"]] == [n["op"] for n in theirs["nodes"]]
    assert ours["nodes"] == theirs["nodes"]
    assert (ours["inputs"], ours["outputs"], ours["opset"]) == \
        (theirs["inputs"], theirs["outputs"], theirs["opset"])


def test_run_model_keeps_activations_channels_last(net, monkeypatch):
    """Every InstanceNormalization node reaches the IN wrapper with a
    channels_last tensor (the layout the card's kernel takes, no copy)."""
    seen = []
    real = onnx_runtime.instance_norm

    def spy(x, *a, **kw):
        seen.append((x.is_contiguous(memory_format=torch.channels_last), kw.get("relu")))
        return real(x, *a, **kw)

    monkeypatch.setattr(onnx_runtime, "instance_norm", spy)
    data = onnx_export.build_onnx_model(net["port"], input_shape=(1, 3, 32, 32))
    x = np.random.default_rng(2).standard_normal((1, 3, 32, 32)).astype(np.float32)
    onnx_runtime.run_model(data, {"input_image": x}, device="cpu")
    assert seen == [(True, None)] * 14


@pytest.mark.parametrize("variant", ["two_input", "alpha_input", "baked_luma"])
def test_adain_run_model_matches_jax_runtime(adain, variant):
    rng = np.random.default_rng(4)
    content = rng.standard_normal((1, 3, 32, 32)).astype(np.float32)
    style = rng.standard_normal((1, 3, 24, 32)).astype(np.float32)
    kw, feeds = {}, {"content_image": content, "style_image": style}
    if variant == "alpha_input":
        kw = {"alpha": "input", "content_shape": (1, 3, "h", "w"),
              "style_shape": (1, 3, "sh", "sw")}
        feeds["alpha"] = np.float32(0.6)
    dec = adain["tdec"]
    if variant == "baked_luma":
        kw = {"baked_style": _baked(6), "preserve_color": "luma"}
        feeds = {"content_image": content}
        # the seeded decoder's output is nearly flat, and luma divides by
        # its luminance std, which would scale f32 roundoff by orders of
        # magnitude: scale the last conv so the output has an image's spread
        last = [k for k in dec if k.endswith(".weight")][-1]
        dec = {k: v * 1000.0 if k in (last, last[:-6] + "bias") else v
               for k, v in dec.items()}
    data = onnx_adain.build_adain_onnx(dec, adain["tvgg"], **kw)
    (got,) = onnx_runtime.run_model(data, feeds, device="cpu")
    (want,) = j_runtime.run_model(data, feeds)
    assert got.shape == want.shape == (1, 3, 32, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=TOL * max(1.0, float(np.abs(want).max())))


def test_protoc_decodes_the_port_bytes(net, adain):
    if shutil.which("protoc") is None:
        pytest.skip("protoc not available")
    for data in (onnx_export.build_onnx_model(net["port"]),
                 onnx_adain.build_adain_onnx(adain["tdec"], adain["tvgg"],
                                             content_shape=(1, 3, 32, 32))):
        r = subprocess.run(["protoc", f"-I{PROTO.parent}", PROTO.name,
                            "--decode=onnx.ModelProto"], input=data, capture_output=True)
        assert r.returncode == 0, r.stderr.decode()[:2000]
        text = r.stdout.decode()
        assert 'producer_name: "fast_neural_style_transfer_tpu_torch"' in text
        assert 'name: "output_image"' in text and "type: INTS" in text


def _tiny_fixture_oracle():
    """The golden fixture's weights and input (tests/test_onnx_interop.py's
    ``_tiny_model_weights``, seed 42) and its output by plain torch ops."""
    import torch.nn.functional as F

    r = np.random.default_rng(42)
    w = {
        "W1": r.normal(0, 0.3, (3, 3, 3, 3)).astype(np.float32),
        "b1": r.normal(0, 0.1, (3,)).astype(np.float32),
        "scale": r.normal(1, 0.2, (3,)).astype(np.float32),
        "bias": r.normal(0, 0.1, (3,)).astype(np.float32),
        "W2": r.normal(0, 0.3, (3, 2, 3, 3)).astype(np.float32),
        "b2": r.normal(0, 0.1, (2,)).astype(np.float32),
        "x": r.normal(0, 1, (1, 3, 8, 8)).astype(np.float32),
    }
    t = {k: torch.from_numpy(v) for k, v in w.items()}
    h = F.conv2d(F.pad(t["x"], (1, 1, 1, 1), mode="reflect"), t["W1"], t["b1"])
    h = F.relu(F.instance_norm(h, weight=t["scale"], bias=t["bias"], eps=1e-5)) + t["x"]
    y = F.conv_transpose2d(h, t["W2"], t["b2"], stride=2, padding=1, output_padding=1)
    return w["x"], y.numpy()


def test_golden_protoc_fixture_runs():
    """protoc-encoded bytes (packed repeated ints, as protoc and onnx write
    them) parse and run in the port's runtime."""
    data = (FIXTURES / "tiny_protoc.onnx").read_bytes()
    m = onnx_runtime.parse_model(data)
    assert [n["op"] for n in m["nodes"]] == [
        "Pad", "Conv", "InstanceNormalization", "Relu", "Add", "ConvTranspose"]
    assert m["nodes"][5]["attrs"]["strides"] == [2, 2]
    x, want = _tiny_fixture_oracle()
    (got,) = onnx_runtime.run_model(data, {"input_image": x}, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_runtime_refuses_what_it_does_not_implement():
    def one_node(op, **attrs):
        g = ow.graph([ow.node(op, ["x", "w"], ["y"], **attrs)], "g",
                     inputs=[ow.value_info("x", (1, 1, 4, 4))],
                     outputs=[ow.value_info("y", (1, 1, 4, 4))],
                     initializers=[ow.tensor("w", np.ones((1, 1, 1, 1), np.float32))])
        return ow.model(g)

    x = np.zeros((1, 1, 4, 4), np.float32)
    for op, attrs, match in [("Conv", {"pads": [1, 1, 1, 1]}, "pads"),
                             ("Conv", {"group": 2}, "group"),
                             ("Gemm", {}, "Gemm")]:
        with pytest.raises(NotImplementedError, match=match):
            onnx_runtime.run_model(one_node(op, **attrs), {"x": x}, device="cpu")


def test_onnx_stylize_file(net, tmp_path):
    from PIL import Image

    model = onnx_export.export_onnx(net["port"], str(tmp_path / "m.onnx"))
    src = str(tmp_path / "in.png")
    Image.fromarray(np.random.default_rng(3).integers(0, 256, (40, 48, 3), np.uint8)).save(src)
    out = onnx_runtime.onnx_stylize(model, src, str(tmp_path / "out.png"), device="cpu")
    assert Image.open(out).size == (256, 256)
