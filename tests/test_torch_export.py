"""The port's export layer against the JAX package's, on the CPU.

Same weights on both sides (JAX ``init`` from a seed, carried across by
``params_from_jax``, ``decoder_params_from_jax``, ``vgg_params_from_jax``),
inputs from numpy seeds.

Tolerances: state dicts, the training ``.pth`` and the hub's files bit for
bit (the same float32 values, reordered and saved); the TorchScript
archive's forward against JAX ``TransformerNet.apply`` 1e-4 absolute in
network space (f32 convs and 14 instance norms with sums in other orders);
the AdaIN archive against the JAX package's AdaIN archive 1e-4 of the
output's largest magnitude (the same plain torch ops, traced by each).
"""

import argparse
import importlib
import os
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from fast_neural_style_transfer_tpu.export import cli as jexport_cli
from fast_neural_style_transfer_tpu.export import hf as jhf
from fast_neural_style_transfer_tpu.export.onnx_adain import build_adain_onnx
from fast_neural_style_transfer_tpu.export import onnx_runtime as j_runtime
from fast_neural_style_transfer_tpu.export import torch_adain as jtorch_adain
from fast_neural_style_transfer_tpu.export import torch_convert as jconvert
from fast_neural_style_transfer_tpu.models.transformer import TransformerNet as JaxNet
from fast_neural_style_transfer_tpu.models.vgg import VGG19Features as JaxVGG
from fast_neural_style_transfer_tpu.models.vgg_weights import save_npz as jax_save_vgg
from fast_neural_style_transfer_tpu.train.checkpoint import save_params_npz as jax_save_npz
from fast_neural_style_transfer_tpu_torch.cli import adain as tcli
from fast_neural_style_transfer_tpu_torch.export import cli as export_cli
from fast_neural_style_transfer_tpu_torch.export import hf, onnx_runtime, torch_adain
from fast_neural_style_transfer_tpu_torch.export import torch_convert, torchscript
from fast_neural_style_transfer_tpu_torch.models import params_from_jax
from fast_neural_style_transfer_tpu_torch.models.adain import decoder_params_from_jax
from fast_neural_style_transfer_tpu_torch.models.transformer import TransformerNet
from fast_neural_style_transfer_tpu_torch.models.vgg_weights import vgg_params_from_jax
from fast_neural_style_transfer_tpu_torch.train.state import (
    create_train_state,
    state_from_reference_checkpoint,
)

jcli = importlib.import_module("fast_neural_style_transfer_tpu.cli.adain")
jadain = importlib.import_module("fast_neural_style_transfer_tpu.models.adain")


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)  # the suite runs with several xdist workers
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def net():
    jp = jax.tree.map(np.asarray, JaxNet.init(jax.random.PRNGKey(5)))
    return {"jax": jp, "port": params_from_jax(jp)}


def test_to_torch_state_dict_matches_jax(net):
    ours = torch_convert.to_torch_state_dict(net["port"])
    theirs = jconvert.to_torch_state_dict(net["jax"])
    assert list(ours) == list(theirs)
    for k in ours:
        assert ours[k].dtype == np.float32
        np.testing.assert_array_equal(ours[k], theirs[k])
    module = TransformerNet()
    module.load_state_dict(net["port"])
    assert all(np.array_equal(a, b) for a, b in
               zip(torch_convert.to_torch_state_dict(module).values(), ours.values()))
    with pytest.raises(ValueError, match="bake_style"):
        torch_convert.to_torch_state_dict(TransformerNet(num_styles=2).state_dict())


def test_checkpoint_round_trip(net, tmp_path):
    path = str(tmp_path / "m.pth")
    torch_convert.save_torch_checkpoint(net["port"], path)
    back = torch_convert.load_torch_checkpoint(path)
    assert all(torch.equal(back[k], net["port"][k]) for k in net["port"])
    theirs = jconvert.load_torch_checkpoint(path)  # the JAX package reads it too
    np.testing.assert_array_equal(np.asarray(theirs["conv1"]["w"]), net["jax"]["conv1"]["w"])


def test_training_checkpoint_round_trip(net, tmp_path):
    """A port TrainState after two Adam updates -> the reference training
    .pth -> the port's full resume and the JAX package's reader, exactly."""
    module = TransformerNet()
    module.load_state_dict(net["port"])
    state = create_train_state(module, lr=1e-3, total_steps=10)
    rng = np.random.default_rng(0)
    for _ in range(2):
        state.optimizer.update([torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32))
                                for p in module.parameters()])
    state.step = 2
    path = str(tmp_path / "train.pth")
    torch_convert.save_torch_training_checkpoint(state, path)

    back = state_from_reference_checkpoint(path, TransformerNet(), lr=1e-3, total_steps=10)
    assert (back.step, back.optimizer.applied) == (2, 2)
    for (name, p), q in zip(module.named_parameters(), back.net.parameters()):
        assert torch.equal(p, q), name
        a, b = state.optimizer.adam.state[p], back.optimizer.adam.state[q]
        assert torch.equal(a["exp_avg"], b["exp_avg"]) and \
            torch.equal(a["exp_avg_sq"], b["exp_avg_sq"]) and float(b["step"]) == 2.0

    params, mu, nu, count, iteration = jconvert.from_torch_training_checkpoint(path)
    assert (count, iteration) == (2, 2)
    want_mu = jconvert.from_torch_state_dict(
        {k: state.optimizer.adam.state[p]["exp_avg"] for k, p in module.named_parameters()})
    for a, b in zip(jax.tree.leaves(mu), jax.tree.leaves(want_mu)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert len(jax.tree.leaves(nu)) == len(jax.tree.leaves(params)) == 58


@pytest.mark.parametrize("hw", [(64, 64), (48, 80)], ids=["64x64", "48x80"])
def test_torchscript_matches_jax_apply(net, hw, tmp_path):
    path = torchscript.export_torchscript(net["port"], str(tmp_path / "m.pt"), example_hw=32)
    module = torch.jit.load(path, map_location="cpu")
    names = {n for n, _ in module.named_parameters()}
    assert "net.conv1.conv.weight" in names and len(names) == 58  # weights, not constants
    x = np.random.default_rng(2).standard_normal((2, *hw, 3)).astype(np.float32)
    with torch.no_grad():
        got = module(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    want = np.asarray(JaxNet.apply(net["jax"], x, train=False))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert torchscript.check_torchscript(path, net["port"], device="cpu", hw=32) <= 1e-4


def test_package_for_hub_matches_jax(net, tmp_path, monkeypatch):
    ours = hf.package_for_hub(net["port"], str(tmp_path / "ours"), metadata={"style": "x"})
    theirs = jhf.package_for_hub(net["jax"], str(tmp_path / "jax"))
    assert sorted(os.listdir(ours)) == ["README.md", "config.json", "model.onnx",
                                        "params.npz", "pytorch_model.pth"]
    with np.load(os.path.join(ours, "params.npz")) as a, \
            np.load(os.path.join(theirs, "params.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    pa = torch.load(os.path.join(ours, "pytorch_model.pth"), weights_only=True)
    pb = torch.load(os.path.join(theirs, "pytorch_model.pth"), weights_only=True)
    assert list(pa) == list(pb) and all(torch.equal(pa[k], pb[k]) for k in pa)
    card = open(os.path.join(ours, "README.md")).read()
    assert "PyTorch/CUDA" in card and "H100" in card
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)  # import fails
    with pytest.raises(RuntimeError, match="huggingface_hub"):
        hf.upload_to_hub(ours, "user/repo")


def _options(parser):
    return {o for a in parser._actions for o in a.option_strings}


def test_export_cli_flags_match_jax(monkeypatch):
    """Every flag of the JAX package's export CLI, plus --device/--cpu."""
    captured = {}

    def capture(self, *a, **kw):
        captured["parser"] = self
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(SystemExit):
        jexport_cli.main([])
    got, want = _options(export_cli.build_parser()), _options(captured["parser"])
    assert want <= got and got - want == {"--device", "--cpu"}


def test_export_cli_on_cpu(net, tmp_path):
    """Every artifact of the export CLI from a multi-style checkpoint with
    --style-index: the baked style's graph, archive, .pth and hub dir."""
    multi = jax.tree.map(np.asarray, JaxNet.init(jax.random.PRNGKey(6), num_styles=2))
    ckpt = str(tmp_path / "multi.npz")
    jax_save_npz(multi, ckpt)
    out = {k: str(tmp_path / f"m.{k}") for k in ("onnx", "pt", "pth")}
    wrote = export_cli.main(["--model", ckpt, "--style-index", "1", "--onnx", out["onnx"],
                             "--onnx-dynamic", "--torchscript", out["pt"], "--pth", out["pth"],
                             "--hub-dir", str(tmp_path / "hub"), "--cpu"])
    assert wrote == [out["onnx"], out["pt"], out["pth"], str(tmp_path / "hub")]
    from fast_neural_style_transfer_tpu.infer.stylize import Stylizer as JaxStylizer
    from fast_neural_style_transfer_tpu.models.transformer import bake_style as jbake

    baked = jbake(multi, 1)
    x = np.random.default_rng(3).standard_normal((1, 3, 36, 44)).astype(np.float32)
    (got,) = onnx_runtime.run_model(open(out["onnx"], "rb").read(), {"input_image": x},
                                    device="cpu")
    want = np.asarray(JaxNet.apply(baked, np.transpose(x, (0, 2, 3, 1)), train=False))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=1e-4)
    theirs = JaxStylizer.load_params(out["pth"])
    for a, b in zip(jax.tree.leaves(theirs), jax.tree.leaves(baked)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(SystemExit):
        export_cli.main(["--model", ckpt, "--onnx-dynamic", "--cpu"])
    with pytest.raises(SystemExit):
        export_cli.main(["--model", ckpt, "--cpu"])  # nothing to do


# -- AdaIN ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def adain(tmp_path_factory):
    d = tmp_path_factory.mktemp("adain")
    vgg = jax.tree.map(np.asarray, JaxVGG.init(jax.random.PRNGKey(0)))
    dec = jax.tree.map(np.asarray, jadain.AdaINDecoder.init(jax.random.PRNGKey(1)))
    jax_save_vgg(vgg, str(d / "vgg.npz"))
    jax_save_npz(dec, str(d / "dec.npz"))
    rng = np.random.default_rng(8)
    Image.fromarray(rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)).save(d / "style.png")
    return {"vgg": vgg, "dec": dec, "tvgg": vgg_params_from_jax(vgg),
            "tdec": decoder_params_from_jax(dec), "dir": d}


def test_adain_decoder_pth_round_trip(adain, tmp_path):
    path = torch_adain.save_torch_adain_decoder(adain["tdec"], str(tmp_path / "d.pth"))
    back = torch_adain.load_torch_adain_decoder(path)
    assert all(torch.equal(back[k], adain["tdec"][k]) for k in adain["tdec"])
    theirs = jtorch_adain.load_torch_adain_decoder(path)
    for a, b in zip(theirs["convs"], adain["dec"]["convs"]):
        np.testing.assert_array_equal(a["w"], b["w"])
    dec = torch_adain.build_torch_decoder()
    dec.load_state_dict(torch.load(path, weights_only=True), strict=True)
    with pytest.raises(ValueError, match="torch"):
        torch_adain.load_torch_adain_decoder(str(tmp_path / "d.npz"))


def test_adain_torchscript_matches_jax_archive(adain, tmp_path):
    ours = torch_adain.export_adain_torchscript(adain["tdec"], adain["tvgg"],
                                                str(tmp_path / "o.pt"), alpha=0.7, example_hw=32)
    theirs = jtorch_adain.export_adain_torchscript(adain["dec"], adain["vgg"],
                                                   str(tmp_path / "j.pt"), alpha=0.7,
                                                   example_hw=32)
    rng = np.random.default_rng(9)
    c = torch.from_numpy(rng.standard_normal((1, 3, 40, 32)).astype(np.float32))
    s = torch.from_numpy(rng.standard_normal((1, 3, 32, 48)).astype(np.float32))
    a = torch.jit.load(ours, map_location="cpu")
    assert len(list(a.parameters())) == 2 * (9 + 9)  # VGG to relu4_1, decoder
    with torch.no_grad():
        got, want = a(c, s), torch.jit.load(theirs)(c, s)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * float(want.abs().max()))


def test_adain_cli_export(adain, tmp_path):
    """``cli/adain.py export`` writes the JAX CLI's two-input graph (bit for
    bit but the producer), a TorchScript archive, and a baked-style graph
    that runs like the two-input one fed that style."""
    d = adain["dir"]
    common = ["export", "--decoder", str(d / "dec.npz"), "--vgg_weights", str(d / "vgg.npz"),
              "--content_shape", "32", "32", "--style_shape", "40", "48"]
    tcli.main(common + ["--onnx", str(tmp_path / "o.onnx"), "--torchscript",
                        str(tmp_path / "o.pt"), "--alpha", "0.8", "--cpu"])
    jcli.main(common + ["--onnx", str(tmp_path / "j.onnx"), "--alpha", "0.8"])
    ours, theirs = (open(tmp_path / n, "rb").read() for n in ("o.onnx", "j.onnx"))
    assert [f for f in onnx_runtime._fields(ours) if f[0] != 2] == \
        [f for f in onnx_runtime._fields(theirs) if f[0] != 2]
    assert os.path.getsize(tmp_path / "o.pt") > 0

    tcli.main(common + ["--onnx", str(tmp_path / "baked.onnx"), "--style_image",
                        str(d / "style.png"), "--cpu"])
    baked = open(tmp_path / "baked.onnx", "rb").read()
    assert onnx_runtime.parse_model(baked)["inputs"] == ["content_image"]
    from fast_neural_style_transfer_tpu_torch.utils import load_image

    style = np.transpose(load_image(str(d / "style.png"), None), (0, 3, 1, 2))
    c = np.random.default_rng(10).standard_normal((1, 3, 32, 32)).astype(np.float32)
    two = open(tmp_path / "o.onnx", "rb").read()
    (got,) = onnx_runtime.run_model(baked, {"content_image": c}, device="cpu")
    two_input = onnx_runtime.parse_model(two)
    assert two_input["inputs"] == ["content_image", "style_image"]
    (want,) = j_runtime.run_model(
        build_adain_onnx(adain["dec"], adain["vgg"], content_shape=(1, 3, 32, 32),
                         style_shape=(1, 3, 40, 48)),
        {"content_image": c, "style_image": style})
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * max(1.0, float(np.abs(want).max())))
    for bad, match in [(["--torchscript", "x.pt", "--style_image", "s"], "ONNX-only"),
                       (["--onnx", "x.onnx", "--style_blend", "1"], "does nothing")]:
        with pytest.raises(SystemExit, match=match):
            tcli.main(["export", "--decoder", "d.npz", *bad, "--cpu"])



def test_package_adain_for_hub_matches_jax(adain, tmp_path):
    ours = hf.package_adain_for_hub(adain["tdec"], adain["tvgg"], str(tmp_path / "ours"))
    theirs = jhf.package_adain_for_hub(adain["dec"], adain["vgg"], str(tmp_path / "jax"))
    assert sorted(os.listdir(ours)) == ["README.md", "adain_pipeline.onnx", "config.json",
                                        "decoder.npz", "decoder.pth"]
    with np.load(os.path.join(ours, "decoder.npz")) as a, \
            np.load(os.path.join(theirs, "decoder.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    a, b = (open(os.path.join(d, "adain_pipeline.onnx"), "rb").read() for d in (ours, theirs))
    assert [f for f in onnx_runtime._fields(a) if f[0] != 2] == \
        [f for f in onnx_runtime._fields(b) if f[0] != 2]
    back = torch_adain.load_torch_adain_decoder(os.path.join(ours, "decoder.pth"))
    assert all(torch.equal(back[k], adain["tdec"][k]) for k in back)
