"""The port's AdaIN family against the JAX package's on the CPU.

Same inputs on both sides: content and style images from a numpy seed, the
JAX package's seeded random VGG19 and decoder params carried across
(``vgg_params_from_jax``, ``decoder_params_from_jax``). Small sizes: 32x32
content (relu4_1 at 4x4), f32.

Tolerances, each stated where it is used:
- channel statistics, AdaIN: 1e-5 relative (f32 sums over a few hundred
  elements in another order); style moments through the VGG: 1e-4 of the
  largest;
- decoder, stylize_arbitrary: 1e-4 of the output's largest magnitude (9
  convs, f32, other summation orders);
- u8 outputs: max |delta| <= 1 (one rounding step of *255 + 0.5);
- loss 1e-4 relative, decoder gradients 1e-3 of the largest gradient (the
  training tests' bounds: f32 through ~20 convs both ways);
- one Adam step: Adam's first update is lr * g / (|g| + 1e-8), so elements
  whose gradient is within a few hundred 1e-8 of zero swing with its last
  bits; where |g| >= 1e-4 the updated params agree within 1e-3 lr, and all
  within 2 lr.
"""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from fast_neural_style_transfer_tpu.core.dtypes import Precision as JaxPrecision
from fast_neural_style_transfer_tpu.infer.adain import ArbitraryStylizer as JaxArbitrary
from fast_neural_style_transfer_tpu.models.vgg import VGG19Features as JaxVGG
from fast_neural_style_transfer_tpu.train.checkpoint import save_params_npz as jax_save_npz
from fast_neural_style_transfer_tpu.train.state import create_train_state as jax_state
from fast_neural_style_transfer_tpu.utils.color import match_color as jax_match_color
from fast_neural_style_transfer_tpu_torch.cli import adain as tcli
from fast_neural_style_transfer_tpu_torch.core.dtypes import Precision
from fast_neural_style_transfer_tpu_torch.infer.adain import ArbitraryStylizer
from fast_neural_style_transfer_tpu_torch.models import adain as tadain
from fast_neural_style_transfer_tpu_torch.models.vgg_weights import make_vgg, vgg_params_from_jax
from fast_neural_style_transfer_tpu_torch.parallel import make_mesh_plan
from fast_neural_style_transfer_tpu_torch.serve import http as serve_http
from fast_neural_style_transfer_tpu_torch.train import adain as ttrain
from fast_neural_style_transfer_tpu_torch.utils.color import match_color
from fast_neural_style_transfer_tpu_torch.utils.image_io import normalize_image

# the JAX package's modules (its packages re-export functions named adain)
jcli = importlib.import_module("fast_neural_style_transfer_tpu.cli.adain")
jadain = importlib.import_module("fast_neural_style_transfer_tpu.models.adain")
jtrain = importlib.import_module("fast_neural_style_transfer_tpu.train.adain")

HW = 32
LR = 1e-3


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)  # the suite runs with several xdist workers
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def s():
    rng = np.random.default_rng(0)
    vgg = jax.tree.map(np.asarray, JaxVGG.init(jax.random.PRNGKey(0)))
    dec = jax.tree.map(np.asarray, jadain.AdaINDecoder.init(jax.random.PRNGKey(1)))
    return {
        "vgg": vgg,
        "dec": dec,
        "tvgg": make_vgg(vgg_params_from_jax(vgg), "cpu"),
        "tdec": tadain.make_decoder(tadain.decoder_params_from_jax(dec), "cpu").eval(),
        "content_u8": rng.integers(0, 256, (2, HW, HW, 3), dtype=np.uint8),
        "style_u8": [rng.integers(0, 256, (1, 24 + 8 * i, 32, 3), dtype=np.uint8)
                     for i in range(2)],
        "feat": rng.normal(size=(2, 4, 4, 512)).astype(np.float32) * 3 + 1,
        "sfeat": rng.normal(size=(2, 5, 6, 512)).astype(np.float32) * 2 - 0.5,
    }


def _close(got, want, frac):
    """|got - want| <= frac * max|want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=frac * np.abs(want).max())


def _net(u8):
    return normalize_image(np.asarray(u8))


def test_channel_stats_matches_jax(s):
    """1e-5 relative: f32 moments over 30 pixels, other order."""
    mean, std = tadain.channel_stats(torch.from_numpy(s["sfeat"]))
    jm, js = jadain.channel_stats(jnp.asarray(s["sfeat"]))
    assert mean.shape == (2, 1, 1, 512)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jm), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(std.numpy(), np.asarray(js), rtol=1e-5)


@pytest.mark.parametrize("style_batch", [1, 2])
def test_adain_matches_jax(s, style_batch):
    """AdaIN with one style row for the batch and with one per sample:
    1e-5 of the largest output (f32)."""
    sf = s["sfeat"][:style_batch]
    got = tadain.adain(torch.from_numpy(s["feat"]), torch.from_numpy(sf))
    want = jadain.adain(jnp.asarray(s["feat"]), jnp.asarray(sf))
    _close(got.numpy(), want, 1e-5)
    # the output carries the style's statistics
    mu, sd = tadain.channel_stats(got)
    ms, ss = tadain.channel_stats(torch.from_numpy(sf))
    np.testing.assert_allclose(mu.numpy(), np.broadcast_to(ms.numpy(), mu.shape),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(sd.numpy(), np.broadcast_to(ss.numpy(), sd.shape),
                               rtol=1e-3)


def test_blended_style_stats_matches_jax(s):
    """Folded moments of two styles at weights (0.3, 0.7), through the
    VGG's 10 convs to relu4_1: 1e-4 of the largest (f32)."""
    styles = [_net(u) for u in s["style_u8"]]
    mu, sigma = tadain.blended_style_stats(
        s["tvgg"], [torch.from_numpy(x) for x in styles], [0.3, 0.7])
    jm, js = jadain.blended_style_stats(
        jax.tree.map(jnp.asarray, s["vgg"]), [jnp.asarray(x) for x in styles], [0.3, 0.7])
    _close(mu.numpy(), jm, 1e-4)
    _close(sigma.numpy(), js, 1e-4)


def test_resolve_style_weights_refuses_bad_weights():
    with pytest.raises(ValueError, match="convex"):
        tadain.resolve_style_weights(["a", "b"], [0.5, 0.7])
    with pytest.raises(ValueError, match="2 style images"):
        tadain.resolve_style_weights(["a", "b"], [1.0])
    assert tadain.resolve_style_weights("a", None) == (["a"], [1.0])


def test_decoder_matches_jax(s):
    """The 9-conv decoder, relu4_1 (2, 4, 4, 512) -> (2, 32, 32, 3): 1e-4
    of the largest output (f32); the parameter layout is the public one."""
    keys = [k for k in s["tdec"].state_dict() if k.endswith("weight")]
    assert keys == [f"{i}.weight" for i in (1, 5, 8, 11, 14, 18, 21, 25, 28)]
    with torch.no_grad():
        got = s["tdec"](torch.from_numpy(s["feat"]))
    want = jadain.AdaINDecoder.apply(jax.tree.map(jnp.asarray, s["dec"]),
                                     jnp.asarray(s["feat"]))
    assert got.shape == (2, 32, 32, 3)
    _close(got.numpy(), want, 1e-4)


def test_feature_masks_matches_jax():
    m = np.random.default_rng(3).random((2, 16, 24)).astype(np.float32)
    m[:, :8, :8] = 0.0  # a pixel block with every mask 0: the uniform blend
    got = tadain.feature_masks(m, (16, 24), 2)
    want = jadain.feature_masks(jnp.asarray(m), (16, 24), 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="spatial shape"):
        tadain.feature_masks(m, (8, 24), 2)


@pytest.mark.parametrize("case", ["single", "weights", "masks", "alpha"])
def test_stylize_arbitrary_matches_jax(s, case):
    """One style; two at (0.25, 0.75); two under per-pixel masks; one at
    alpha 0.6. 1e-4 of the largest output (f32)."""
    content = _net(s["content_u8"][:1])
    styles = [_net(u) for u in s["style_u8"]]
    kw = {}
    if case == "single":
        styles = styles[:1]
    elif case == "weights":
        kw["style_weights"] = [0.25, 0.75]
    elif case == "masks":
        m = np.zeros((2, HW, HW), np.float32)
        m[0, :, : HW // 2] = 1.0
        m[1, :, HW // 2:] = 1.0
        kw["style_masks"] = m
    else:
        styles = styles[:1]
        kw["alpha"] = 0.6
    with torch.no_grad():
        got = tadain.stylize_arbitrary(s["tdec"], s["tvgg"], torch.from_numpy(content),
                                       [torch.from_numpy(x) for x in styles], **kw)
    want = jadain.stylize_arbitrary(
        jax.tree.map(jnp.asarray, s["dec"]), jax.tree.map(jnp.asarray, s["vgg"]),
        jnp.asarray(content), [jnp.asarray(x) for x in styles], **kw)
    _close(got.numpy(), want, 1e-4)


def test_stylize_arbitrary_refuses_masks_with_weights(s):
    with pytest.raises(ValueError, match="mutually exclusive"):
        tadain.stylize_arbitrary(s["tdec"], s["tvgg"], torch.zeros(1, HW, HW, 3),
                                 [torch.zeros(1, HW, HW, 3)] * 2,
                                 style_weights=[0.5, 0.5],
                                 style_masks=np.ones((2, HW, HW), np.float32))


@pytest.mark.parametrize("alpha,color", [(1.0, "off"), (0.7, "off"), (1.0, "luma")])
def test_arbitrary_stylizer_u8_matches_jax(s, alpha, color):
    """u8 in, u8 out with a cached blend of two styles, a 40x36 content
    padded to the 64 bucket: max |delta u8| <= 1 (f32)."""
    img = np.random.default_rng(7).integers(0, 256, (2, 40, 36, 3), dtype=np.uint8)
    styles = [u[0] for u in s["style_u8"]]
    port = ArbitraryStylizer(tadain.decoder_params_from_jax(s["dec"]),
                             vgg_params_from_jax(s["vgg"]), device="cpu",
                             preserve_color=color).set_style_u8(styles, [0.4, 0.6])
    jax_sty = JaxArbitrary(jax.tree.map(jnp.asarray, s["dec"]),
                           jax.tree.map(jnp.asarray, s["vgg"]),
                           preserve_color=color).set_style_u8(styles, [0.4, 0.6])
    got = port.stylize_u8(img, alpha=alpha)
    want = jax_sty.stylize_u8(img, alpha=alpha)
    assert got.shape == img.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert port.stylize_u8(img[0], alpha=alpha).shape == img.shape[1:]


def test_arbitrary_stylizer_refusals(s):
    sd, vsd = tadain.decoder_params_from_jax(s["dec"]), vgg_params_from_jax(s["vgg"])
    with pytest.raises(ValueError, match="no style set"):
        ArbitraryStylizer(sd, vsd, device="cpu").stylize_u8(
            np.zeros((8, 8, 3), np.uint8))
    with pytest.raises(ValueError, match="match"):
        ArbitraryStylizer(sd, vsd, device="cpu", preserve_color="match")
    # a replica plan is taken (tests/test_torch_data_parallel.py runs it);
    # a device other than the plan's first is refused
    plan = make_mesh_plan(devices=["cpu", "cpu"])
    assert ArbitraryStylizer(sd, vsd, sharding=plan.batch_sharding).device == torch.device("cpu")
    with pytest.raises(ValueError, match="first device"):
        ArbitraryStylizer(sd, vsd, device="meta", sharding=plan.batch_sharding)
    with pytest.raises(TypeError, match="uint8"):
        ArbitraryStylizer(sd, vsd, device="cpu").set_style_u8(np.zeros((8, 8, 3)))


def test_match_color_matches_jax():
    """Whitening-colouring of a 16x16 image to another's RGB moments: 1e-4
    of the largest value (f32 eigendecompositions)."""
    rng = np.random.default_rng(4)
    src = rng.normal(size=(1, 16, 16, 3)).astype(np.float32)
    tgt = (rng.normal(size=(1, 12, 20, 3)) * [0.5, 1.0, 2.0] + 0.3).astype(np.float32)
    got = match_color(torch.from_numpy(src), torch.from_numpy(tgt))
    _close(got.numpy(), jax_match_color(jnp.asarray(src), jnp.asarray(tgt)), 1e-4)


# -- training -----------------------------------------------------------------


def _style_batch(s):
    """(2, 24, 32, 3): a style per content image."""
    return np.ascontiguousarray(
        np.concatenate([s["style_u8"][0], s["style_u8"][0][:, ::-1]]))


def _jax_loss(s, params, sw=10.0):
    vgg = jax.tree.map(jnp.asarray, s["vgg"])
    return jtrain.adain_loss_fn(params, vgg, jnp.asarray(s["content_u8"]),
                                jnp.asarray(_style_batch(s)), jnp.float32(sw),
                                precision=JaxPrecision.f32())


@pytest.mark.parametrize("remat", [False, True])
def test_adain_loss_and_grads_match_jax(s, remat):
    """One f32 loss and its decoder gradients against jax.grad, with and
    without recomputing the decoder and the output encode in the backward
    (``remat``): loss 1e-4 relative, gradients 1e-3 of the largest."""
    (total, metrics), grads = jax.value_and_grad(
        lambda p: _jax_loss(s, p), has_aux=True)(jax.tree.map(jnp.asarray, s["dec"]))
    dec = tadain.make_decoder(tadain.decoder_params_from_jax(s["dec"]), "cpu")
    got, tm = ttrain.adain_loss_fn(dec, s["tvgg"], torch.from_numpy(s["content_u8"]),
                                   torch.from_numpy(_style_batch(s)), 10.0,
                                   precision=Precision.f32(), remat=remat)
    np.testing.assert_allclose(float(got.detach()), float(total), rtol=1e-4)
    for k in ("content_loss", "style_loss"):
        np.testing.assert_allclose(float(tm[k]), float(metrics[k]), rtol=1e-4)
    tgrads = torch.autograd.grad(got, list(dec.parameters()))
    want = tadain.decoder_params_from_jax(jax.tree.map(np.asarray, grads))
    gmax = max(np.abs(v.numpy()).max() for v in want.values())
    for (name, _), g in zip(dec.named_parameters(), tgrads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=0,
                                   atol=1e-3 * gmax, err_msg=name)


def test_adain_step_with_lr_decay_matches_jax(s):
    """One synced Adam step at lr_decay 0.5 from step 3 (factor 1/2.5):
    updated params where the effective gradient is >= 1e-4 within 1e-3 lr,
    all within 2 lr; step counts 3 -> 4; grad_norm 1e-4 relative."""
    import optax

    decay, start = 0.5, 3
    opt = optax.adam(LR)
    jstate = jax_state(jax.tree.map(jnp.asarray, s["dec"]), opt)._replace(
        step=jnp.asarray(start, jnp.int32))
    jstep = jtrain.make_adain_train_step(opt, donate=False, lr_decay=decay)
    new, jm = jstep(jstate, jax.tree.map(jnp.asarray, s["vgg"]),
                    jnp.asarray(s["content_u8"]), jnp.asarray(_style_batch(s)))
    (_, _), grads = jax.value_and_grad(lambda p: _jax_loss(s, p), has_aux=True)(
        jax.tree.map(jnp.asarray, s["dec"]))

    state = ttrain.create_adain_train_state(
        tadain.make_decoder(tadain.decoder_params_from_jax(s["dec"]), "cpu"), LR)
    state.step = start
    tm = ttrain.make_adain_train_step(lr=LR, lr_decay=decay)(
        state, s["tvgg"], torch.from_numpy(s["content_u8"]),
        torch.from_numpy(_style_batch(s)))
    assert state.step == start + 1 and int(new.step) == start + 1
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    assert float(tm["skipped_nonfinite"]) == 0.0
    want = tadain.decoder_params_from_jax(jax.tree.map(np.asarray, new.params))
    g = tadain.decoder_params_from_jax(jax.tree.map(np.asarray, grads))
    lr_eff = LR * ttrain.lr_decay_factor(decay, start)
    for name, p in state.decoder.named_parameters():
        d = np.abs(p.detach().numpy() - want[name].numpy())
        assert d.max() <= 2 * lr_eff, name
        big = np.abs(g[name].numpy()) >= 1e-4
        assert d[big].max(initial=0.0) <= 1e-3 * lr_eff, name


def test_lr_decay_factor():
    assert ttrain.lr_decay_factor(0.0, 1000) == 1.0
    assert ttrain.lr_decay_factor(5e-5, 20_000) == pytest.approx(
        float(jtrain.lr_decay_factor(5e-5, jnp.asarray(20_000))))


def test_nonfinite_step_reverts(s):
    """A NaN in the content: no update, step stays, skipped_nonfinite 1."""
    state = ttrain.create_adain_train_state(
        tadain.make_decoder(tadain.decoder_params_from_jax(s["dec"]), "cpu"), LR)
    before = [p.detach().clone() for p in state.decoder.parameters()]
    bad = torch.from_numpy(_net(s["content_u8"])).clone()
    bad[0, 0, 0, 0] = float("nan")
    m = ttrain.make_adain_train_step(lr=LR)(
        state, s["tvgg"], bad, torch.from_numpy(_style_batch(s)))
    assert float(m["skipped_nonfinite"]) == 1.0 and state.step == 0
    for a, b in zip(before, state.decoder.parameters()):
        assert torch.equal(a, b)
    assert not state.optimizer.state  # Adam's moments untouched


# -- weights ------------------------------------------------------------------


def test_load_decoder_formats(s, tmp_path):
    """The JAX package's .npz, the public decoder .pth layout (written by
    the JAX package's torch interchange), the port's own torch.save, a
    training checkpoint, and save_decoder_npz read back by the JAX loader:
    all the same weights, exactly."""
    from fast_neural_style_transfer_tpu.export.torch_adain import (
        _load_params_into,
        build_torch_decoder,
    )

    want = tadain.decoder_params_from_jax(s["dec"])
    npz = str(tmp_path / "dec.npz")
    jax_save_npz(s["dec"], npz)
    public = build_torch_decoder()
    _load_params_into(public, s["dec"])
    pth = str(tmp_path / "public.pth")
    torch.save(public.state_dict(), pth)
    own = str(tmp_path / "own.pth")
    torch.save(s["tdec"].state_dict(), own)
    state = ttrain.create_adain_train_state(tadain.make_decoder(want, "cpu"))
    ck = str(tmp_path / "ckpt.pt")
    torch.save(state.state_dict(), ck)
    for path in (npz, pth, own, ck):
        got = tadain.load_decoder(path)
        assert list(got) == list(want)
        for k in want:
            assert torch.equal(got[k], want[k]), (path, k)
    back = str(tmp_path / "back.npz")
    tadain.save_decoder_npz(want, back)
    jback = jcli.load_decoder(back)
    for a, b in zip(jax.tree.leaves(jback), jax.tree.leaves(s["dec"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(ValueError, match="architecture"):
        tadain.decoder_state_dict_from_torch({"0.weight": torch.zeros(4, 512, 3, 3),
                                              "0.bias": torch.zeros(4)})
    with pytest.raises(FileNotFoundError):
        tadain.load_decoder(str(tmp_path / "nowhere"))


# -- CLIs and the server --------------------------------------------------------


def _options(parser, cmd):
    sub = next(a for a in parser._actions if a.dest == "cmd").choices[cmd]
    return {o for a in sub._actions for o in a.option_strings}


@pytest.mark.parametrize("cmd", ["train", "stylize", "export"])
def test_cli_flags_match_jax(cmd):
    """Every flag of the JAX package's subcommand, plus --device/--cpu."""
    got, want = _options(tcli.build_parser(), cmd), _options(jcli.build_parser(), cmd)
    assert want <= got and got - want == {"--device", "--cpu"}


@pytest.mark.parametrize("argv,match", [
    (["export", "--decoder", "d.npz"], "pass --onnx and/or --torchscript"),
    (["stylize", "--decoder", "d.npz", "--content_dir", "c", "--style_image", "s",
      "--data_parallel", "--preserve_color", "match"], "per-content"),
    (["stylize", "--decoder", "d.npz", "--content_dir", "c", "--style_image", "s",
      "--spatial", "2"], "cannot be combined"),
    (["stylize", "--decoder", "d.npz", "--style_image", "s"], "exactly one"),
    (["stylize", "--decoder", "d.npz", "--content_dir", "c", "--style_image", "s",
      "--preserve_color", "match"], "per-content"),
])
def test_cli_refusals(argv, match):
    with pytest.raises(SystemExit, match=match):
        tcli.main(argv)


def _write_images(d, n, seed, size=(HW, HW)):
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (*size, 3), dtype=np.uint8)).save(
            os.path.join(d, f"img_{i}.png"))
    return d


def test_cli_train_then_stylize_on_cpu(tmp_path):
    """Train 2 steps at B=2, 32x32 on the CPU through the CLI, resume to 3
    from its checkpoint, then stylize one image (with masks, luma) and a
    directory with the final .npz, which the JAX package also loads."""
    content = _write_images(str(tmp_path / "content"), 3, 1)
    style = _write_images(str(tmp_path / "style"), 3, 2)
    out = str(tmp_path / "out")
    common = ["train", "--content_dir", content, "--style_dir", style, "--output_dir",
              out, "--batch_size", "2", "--image_size", "32", "32", "--num_workers",
              "2", "--cpu", "--checkpoint_every", "100"]
    with pytest.warns(UserWarning, match="VGG19"):
        final = tcli.main(common + ["--total_steps", "2"])
    assert sorted(os.listdir(os.path.join(out, "checkpoints"))) == ["ckpt_00000002.pt", "latest"]
    with pytest.warns(UserWarning, match="VGG19"):
        tcli.main(common + ["--total_steps", "3"])
    assert "ckpt_00000003.pt" in os.listdir(os.path.join(out, "checkpoints"))
    assert jcli.load_decoder(final)["convs"][-1]["w"].shape == (3, 3, 64, 3)
    masks = [str(tmp_path / f"m{i}.png") for i in range(2)]
    for i, m in enumerate(masks):
        a = np.zeros((HW, HW), np.uint8)
        a[:, i * 16:(i + 1) * 16] = 255
        Image.fromarray(a).save(m)
    single = str(tmp_path / "single.jpg")
    with pytest.warns(UserWarning, match="VGG19"):
        tcli.main(["stylize", "--decoder", final, "--content_image",
                   os.path.join(content, "img_0.png"), "--style_image",
                   os.path.join(style, "img_0.png"), os.path.join(style, "img_1.png"),
                   "--style_masks", *masks, "--preserve_color", "luma", "--output",
                   single, "--cpu"])
    assert Image.open(single).size == (HW, HW)
    with pytest.warns(UserWarning, match="VGG19"):
        written = tcli.main(["stylize", "--decoder", final, "--content_dir", content,
                             "--style_image", os.path.join(style, "img_0.png"),
                             "--output", str(tmp_path / "bulk"), "--batch_size", "2",
                             "--alpha", "0.5", "--cpu"])
    assert len([w for w in written if w]) == 3


def test_serve_adain_flags(s, tmp_path):
    """fnst-serve --adain-decoder --style --alpha --vgg_weights builds the
    'adain' family, whose forward is ArbitraryStylizer's; --adain-decoder
    without --style is refused."""
    import argparse

    dec = str(tmp_path / "dec.npz")
    jax_save_npz(s["dec"], dec)
    vgg = str(tmp_path / "vgg.npz")
    np.savez(vgg, **{f"{k}.{p}": v for k, d in s["vgg"].items() for p, v in d.items()})
    style = str(tmp_path / "style.png")
    Image.fromarray(s["style_u8"][0][0]).save(style)
    args = argparse.Namespace(adain_decoder=dec, style=style, alpha=0.8,
                              vgg_weights=vgg, precision="f32", preserve_color="off",
                              model=None, style_index=None, data_parallel=False)
    fwd, family, device = serve_http._build_forward(args, "cpu")
    assert family == "adain" and str(device) == "cpu"
    img = np.random.default_rng(9).integers(0, 256, (1, 32, 32, 3), dtype=np.uint8)
    want = ArbitraryStylizer(tadain.decoder_params_from_jax(s["dec"]),
                             vgg_params_from_jax(s["vgg"]), device="cpu",
                             ).set_style_u8(s["style_u8"][0][0]).stylize_u8(img, alpha=0.8)
    np.testing.assert_array_equal(fwd(img), want)
    args.style = None
    with pytest.raises(SystemExit, match="--style"):
        serve_http._build_forward(args, "cpu")
