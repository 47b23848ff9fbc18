"""Multi-style training and serving (conditional instance norm) in the port,
against the JAX package on the CPU.

A multi-style net keeps every IN affine as an (S, C) bank; a forward takes
(S,) style weights for the batch or (B, S) rows per example. The banks come
from JAX ``TransformerNet.init(num_styles=S)`` with their rows made to
differ (init gives every style the same ones and zeros), and cross over as
numpy arrays through ``params_from_jax``.

Tolerances: the forward within 1e-4 of the output's range (f32 sums of up
to 2304 products in other orders through 16 layers); the style loss 1e-5
relative; gradients within 1e-3 of the largest gradient, as
``tests/test_torch_train.py`` holds the single-style step.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from fast_neural_style_transfer_tpu.core.dtypes import Precision as JaxPrecision
from fast_neural_style_transfer_tpu.infer.stylize import Stylizer as JaxStylizer
from fast_neural_style_transfer_tpu.losses import LossTaps as JaxTaps
from fast_neural_style_transfer_tpu.losses import perceptual as jloss
from fast_neural_style_transfer_tpu.losses import style_targets_from_features as jax_targets
from fast_neural_style_transfer_tpu.models import VGG19Features as JaxVGG
from fast_neural_style_transfer_tpu.models import transformer as jtr
from fast_neural_style_transfer_tpu.train import schedule as jsched
from fast_neural_style_transfer_tpu.train import step as jstep
from fast_neural_style_transfer_tpu_torch.cli import begin_training
from fast_neural_style_transfer_tpu_torch.core.dtypes import Precision
from fast_neural_style_transfer_tpu_torch.losses import (
    LossTaps,
    perceptual as tloss,
    style_targets_from_features,
)
from fast_neural_style_transfer_tpu_torch.models import (
    TransformerNet,
    bake_style,
    load_checkpoint,
    num_styles,
    params_from_jax,
    require_single_style,
)
from fast_neural_style_transfer_tpu_torch.models.vgg_weights import (
    make_vgg,
    vgg_params_from_jax,
)
from fast_neural_style_transfer_tpu_torch.train import schedule as tsched
from fast_neural_style_transfer_tpu_torch.train import step as tstep
from fast_neural_style_transfer_tpu_torch.train.state import create_train_state
from fast_neural_style_transfer_tpu_torch.utils.image_io import u8_to_network

S = 3
HW = 32


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)  # the suite runs with several xdist workers
    yield
    torch.set_num_threads(prev)


def _distinct_banks(tree, seed):
    """The tree with every IN affine redrawn (gamma around 1, beta around 0,
    negative entries included), so styles differ."""
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, dict):
            if "gamma" in node:
                node["gamma"] = (1 + 0.5 * rng.standard_normal(node["gamma"].shape)
                                 ).astype(np.float32)
                node["beta"] = (0.3 * rng.standard_normal(node["beta"].shape)
                                ).astype(np.float32)
            for v in node.values():
                walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)

    walk(tree)
    return tree


def jax_multi_params(styles=S, key=5, seed=0):
    params = jax.tree.map(np.asarray, jtr.TransformerNet.init(
        jax.random.PRNGKey(key), num_styles=styles))
    return _distinct_banks(params, seed)


@pytest.fixture(scope="module")
def jax_params():
    return jax_multi_params()


def _net(params, styles=S) -> TransformerNet:
    net = TransformerNet(num_styles=styles)
    net.load_state_dict(params_from_jax(params), strict=True)
    return net.eval().to(memory_format=torch.channels_last)


_WEIGHTS = {
    "one_hot": np.eye(S, dtype=np.float32)[1],
    "blend": np.asarray([0.2, 0.5, 0.3], np.float32),
    "per_example": np.eye(S, dtype=np.float32)[[2, 0]],
}


@pytest.mark.parametrize("kind", list(_WEIGHTS))
def test_multi_style_forward_matches_jax(jax_params, kind):
    x = np.random.default_rng(1).standard_normal((2, HW, HW, 3)).astype(np.float32)
    w = _WEIGHTS[kind]
    want = np.asarray(jtr.TransformerNet.apply(
        jax.tree.map(jnp.asarray, jax_params), jnp.asarray(x),
        style_weights=jnp.asarray(w)))
    with torch.inference_mode():
        got = _net(jax_params)(torch.from_numpy(x), style_weights=torch.from_numpy(w))
    assert got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-4 * (want.max() - want.min())


@pytest.mark.parametrize("style", [0, 2, "blend"])
def test_bake_style_equals_the_unbaked_forward(jax_params, style):
    """bake_style collapses the banks as JAX's does, and the single-style
    net it loads into gives the multi-style net's output."""
    w = _WEIGHTS["blend"] if style == "blend" else np.eye(S, dtype=np.float32)[style]
    arg = w if style == "blend" else style
    net = _net(jax_params)
    baked = bake_style(net.state_dict(), arg)
    want = params_from_jax(jax.tree.map(np.asarray, jtr.bake_style(
        jax.tree.map(jnp.asarray, jax_params), arg)))
    assert num_styles(baked) == 1 and set(baked) == set(want)
    for k in want:
        torch.testing.assert_close(baked[k], want[k], rtol=0, atol=1e-7)
    single = TransformerNet()
    single.load_state_dict(baked, strict=True)
    single = single.eval().to(memory_format=torch.channels_last)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, HW, HW, 3)).astype(np.float32))
    with torch.inference_mode():
        torch.testing.assert_close(single(x), net(x, style_weights=torch.from_numpy(w)),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("bad", [True, 3, -1, [0.5, 0.5], [0.5, 0.7, 0.0],
                                 [-0.5, 1.0, 0.5]], ids=str)
def test_bake_style_refuses_what_jax_refuses(jax_params, bad):
    with pytest.raises((TypeError, ValueError)) as want:
        jtr.bake_style(jax.tree.map(jnp.asarray, jax_params), bad)
    with pytest.raises(want.type):
        bake_style(params_from_jax(jax_params), bad)


def test_single_style_guards():
    single = TransformerNet().state_dict()
    with pytest.raises(ValueError, match="already single-style"):
        bake_style(single, 0)
    require_single_style(single, "export")
    multi = TransformerNet(num_styles=2)
    with pytest.raises(ValueError, match="bake_style"):
        require_single_style(multi.state_dict(), "export")
    x = torch.zeros((1, 8, 8, 3))
    with pytest.raises(ValueError, match="need style_weights"):
        multi(x)
    with pytest.raises(ValueError, match="single-style"):
        TransformerNet()(x, style_weights=torch.ones(1))
    with pytest.raises(ValueError, match="num_styles"):
        TransformerNet(num_styles=0)


def test_multi_style_state_dict_matches_jax_layout(jax_params):
    net = TransformerNet(num_styles=S)
    assert sum(p.numel() for p in net.parameters()) == \
        jtr.TransformerNet.param_count(jtr.TransformerNet.init(jax.random.PRNGKey(0), S))
    sd = params_from_jax(jax_params)
    assert list(net.state_dict()) == list(TransformerNet().state_dict())
    assert set(sd) == set(net.state_dict())
    assert sd["norm1.weight"].shape == (S, 64) and sd["res_blocks.4.in2.bias"].shape == (S, 256)
    assert num_styles(sd) == S


def _feats(seed, shapes=((2, 8, 8, 16), (2, 4, 4, 32))):
    rng = np.random.default_rng(seed)
    return [np.abs(rng.standard_normal(s)).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("masked", [False, True])
def test_style_loss_banks_match_jax(masked):
    feats = _feats(3)
    per_style = [jax_targets([jnp.asarray(f[:1]) for f in _feats(10 + s)]) for s in range(S)]
    banks_np = [np.stack([np.asarray(t[layer]) for t in per_style]) for layer in range(2)]
    select = np.asarray([[0.0, 1.0, 0.0], [0.25, 0.25, 0.5]], np.float32)
    mask = np.asarray([1.0, 0.0], np.float32) if masked else None
    weights = (0.4, 0.6)
    want = jloss.style_loss([jnp.asarray(f) for f in feats], [jnp.asarray(b) for b in banks_np],
                            weights, style_select=jnp.asarray(select),
                            batch_mask=None if mask is None else jnp.asarray(mask))
    got = tloss.style_loss([torch.from_numpy(f) for f in feats],
                           [torch.from_numpy(b) for b in banks_np], weights,
                           style_select=torch.from_numpy(select),
                           batch_mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    # JAX's two guards
    single = [torch.from_numpy(b[0]) for b in banks_np]
    with pytest.raises(ValueError, match="need style_select"):
        tloss.style_loss([torch.from_numpy(f) for f in feats],
                         [torch.from_numpy(b) for b in banks_np], weights)
    with pytest.raises(ValueError, match="single-style"):
        tloss.style_loss([torch.from_numpy(f) for f in feats], single, weights,
                         style_select=torch.from_numpy(select))


# -- the step: gradients of loss_fn against JAX's ------------------------------


@pytest.fixture(scope="module")
def step_setup():
    rng = np.random.default_rng(0)
    vgg = jax.tree.map(np.asarray, JaxVGG.init(jax.random.PRNGKey(1)))
    batch = rng.integers(0, 256, (2, HW, HW, 3), dtype=np.uint8)
    styles = rng.integers(0, 256, (2, 1, HW, HW, 3), dtype=np.uint8)
    return {"vgg": vgg, "batch": batch, "styles": styles}


def _jax_grams(s, style_u8):
    x = jstep.normalize_u8_batch(jnp.asarray(style_u8))
    feats = JaxVGG.apply(jax.tree.map(jnp.asarray, s["vgg"]), x, JaxTaps().style_taps)
    return list(jax_targets(feats))


def _jax_grads(s, params, grams, **kw):
    fn = jax.jit(jax.grad(functools.partial(
        jstep.loss_fn, taps=JaxTaps(), precision=JaxPrecision.f32(), **kw), has_aux=True))
    grads, _ = fn(jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, s["vgg"]),
                  jnp.asarray(s["batch"]), grams, jsched.LossWeightSchedule()(0), None)
    return params_from_jax(jax.tree.map(np.asarray, grads))


def _port_grads(s, params, styles, grams, **kw):
    net = TransformerNet(num_styles=styles)
    net.load_state_dict(params_from_jax(params), strict=True)
    net = net.to(memory_format=torch.channels_last)
    vgg = make_vgg(vgg_params_from_jax(s["vgg"]), "cpu")
    total, _ = tstep.loss_fn(net, vgg, torch.from_numpy(s["batch"]), grams,
                             tsched.LossWeightSchedule()(0), taps=LossTaps(),
                             precision=Precision.f32(), dropout=False, **kw)
    names = [n for n, _ in net.named_parameters()]
    return dict(zip(names, torch.autograd.grad(total, list(net.parameters()))))


def _port_grams(s, style_u8):
    vgg = make_vgg(vgg_params_from_jax(s["vgg"]), "cpu")
    with torch.no_grad():
        return style_targets_from_features(
            vgg(u8_to_network(torch.from_numpy(style_u8)), LossTaps().style_taps))


def _assert_grads_close(got, want):
    gmax = max(np.abs(v.numpy()).max() for v in want.values())
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-3 * gmax, err_msg=k)


def test_multi_style_grads_match_jax(step_setup):
    """B=2, S=2, one example per style (an explicit one-hot style_select:
    the two frameworks cannot draw the same styles), dropout off, f32: the
    gradients of every param, the (S, C) IN banks included."""
    s = step_setup
    params = jax_multi_params(styles=2, key=6, seed=1)
    select = np.eye(2, dtype=np.float32)[[1, 0]]
    jgrams = [jnp.stack(layer) for layer in zip(*[_jax_grams(s, st) for st in s["styles"]])]
    want = _jax_grads(s, params, jgrams, style_select=jnp.asarray(select), norm_method="xla")
    tgrams = [torch.stack(layer) for layer in zip(*[_port_grams(s, st) for st in s["styles"]])]
    got = _port_grads(s, params, 2, tgrams, style_select=torch.from_numpy(select))
    assert got["norm1.weight"].shape == (2, 64)
    _assert_grads_close(got, want)


def test_onepass_grads_match_jax(step_setup):
    """norm_method="onepass" against JAX's norm_method="onepass", single-style."""
    s = step_setup
    params = _distinct_banks(jax.tree.map(np.asarray, jtr.TransformerNet.init(
        jax.random.PRNGKey(7))), seed=2)
    want = _jax_grads(s, params, _jax_grams(s, s["styles"][0]), norm_method="onepass")
    got = _port_grads(s, params, 1, _port_grams(s, s["styles"][0]),
                     norm_method="onepass")
    _assert_grads_close(got, want)


def test_train_step_draws_styles_from_its_generator(step_setup, monkeypatch):
    """make_train_step(num_styles=2) draws one style per example from the
    step's generator: the same seed draws the same one-hot rows, and an
    explicit style_select is used as given."""
    s = step_setup
    seen = []
    real = tstep.loss_fn

    def spy(*a, **kw):
        seen.append(kw["style_select"])
        return real(*a, **kw)

    monkeypatch.setattr(tstep, "loss_fn", spy)
    vgg = make_vgg(vgg_params_from_jax(s["vgg"]), "cpu")
    grams = [torch.stack(layer) for layer in zip(*[_port_grams(s, st) for st in s["styles"]])]
    batch = torch.from_numpy(np.concatenate([s["batch"]] * 3))  # 6 examples
    step = tstep.make_train_step(num_styles=2, dropout=False, lr=1e-3, total_steps=10)
    for seed in (3, 3, 4):
        torch.manual_seed(0)
        state = create_train_state(TransformerNet(num_styles=2), 1e-3, 10)
        step(state, vgg, batch, grams, torch.Generator().manual_seed(seed))
        assert state.step == 1
    assert seen[0].shape == (6, 2) and torch.equal(seen[0].sum(1), torch.ones(6))
    assert torch.equal(seen[0], seen[1])
    want = torch.nn.functional.one_hot(torch.randint(
        0, 2, (6,), generator=torch.Generator().manual_seed(4)), 2).float()
    assert torch.equal(seen[2], want)
    explicit = torch.eye(2)[[0, 1, 1, 0, 0, 1]]
    step(state, vgg, batch, grams, torch.Generator(), style_select=explicit)
    assert seen[-1] is explicit


# -- the training CLI --------------------------------------------------------


def _images(root, n, hw, seed):
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (*hw, 3), dtype=np.uint8)).save(
            os.path.join(root, f"{i}.jpg"))


@pytest.fixture(scope="module")
def multi_style_run(tmp_path_factory):
    """begin_training with two style images, 3 steps at 32^2 on the CPU
    -> (tmp dir, final .npz, its stdout, its arguments)."""
    import contextlib
    import io

    tmp = tmp_path_factory.mktemp("multi")
    data, out = str(tmp / "data"), str(tmp / "out")
    _images(data, 5, (40, 44), seed=1)
    _images(str(tmp / "s"), 2, (36, 36), seed=2)
    args = ["--device", "cpu", "--dataset_dir", data, "--style_image",
            str(tmp / "s" / "0.jpg"), str(tmp / "s" / "1.jpg"), "--output_dir", out,
            "--batch_size", "2", "--image_size", "32", "32", "--num_workers", "2",
            "--training_monitor_content_image", "", "--total_steps", "3"]
    text = io.StringIO()
    with pytest.warns(UserWarning, match="VGG19"), contextlib.redirect_stdout(text):
        final = begin_training.main(args)
    return tmp, final, text.getvalue(), args


def test_cli_trains_multi_style(multi_style_run):
    tmp, final, text, args = multi_style_run
    assert "multi-style run: 2 styles via conditional IN" in text
    assert "trained 3 steps" in text
    ours = load_checkpoint(final)
    assert num_styles(ours) == 2 and ours["norm2.weight"].shape == (2, 256)
    theirs = JaxStylizer.load_params(final)  # the JAX package reads the banks
    assert jtr.num_styles(theirs) == 2
    for k, v in params_from_jax(jax.tree.map(np.asarray, theirs)).items():
        assert torch.equal(ours[k], v), k
    # the two styles' banks moved apart from their shared init
    assert not torch.equal(ours["norm1.weight"][0], ours["norm1.weight"][1])
    # a warm start must match the style count
    one = str(tmp / "one.npz")
    from fast_neural_style_transfer_tpu_torch.models import save_params_npz

    save_params_npz(TransformerNet().state_dict(), one)
    with pytest.raises(ValueError, match="style counts must match"):
        begin_training.main(args + ["--checkpoint_path", one, "--output_dir",
                                    str(tmp / "o2")])


@pytest.mark.parametrize("flags,style", [(["--style_index", "1"], 1),
                                          (["--style_blend", "0.5", "0.5"], [0.5, 0.5])],
                         ids=["index", "blend"])
def test_inference_cli_on_the_trained_checkpoint_matches_jax(multi_style_run, flags,
                                                             style, tmp_path):
    """begin_inference with a style flag on the trained multi-style .npz
    against JAX's Stylizer.from_checkpoint(style=...): max |du8| <= 1."""
    from fast_neural_style_transfer_tpu_torch.cli import begin_inference

    _, final, _, _ = multi_style_run
    src = str(tmp_path / "in.png")
    img = np.random.default_rng(5).integers(0, 256, (28, 36, 3), dtype=np.uint8)
    Image.fromarray(img).save(src)
    begin_inference.main(["--model_path", final, "--content_image", src, "--output_dir",
                          str(tmp_path), "--output_name", "o.png", "--device", "cpu",
                          *flags])
    got = np.asarray(Image.open(tmp_path / "o.png"), np.int32)
    want = JaxStylizer.from_checkpoint(final, style=style).stylize_u8(img).astype(np.int32)
    assert got.shape == want.shape == (28, 36, 3)
    assert np.abs(got - want).max() <= 1
    with pytest.raises(SystemExit, match="mutually exclusive"):
        begin_inference.main(["--model_path", final, "--device", "cpu",
                              "--style_index", "0", "--style_blend", "1", "0"])


def test_loop_saves_one_monitor_sample_per_style(tmp_path, capsys):
    from fast_neural_style_transfer_tpu_torch.train.loop import (
        TrainConfig,
        train_style_transfer,
    )

    data = str(tmp_path / "data")
    _images(data, 4, (36, 36), seed=4)
    cfg = TrainConfig(style_image=(os.path.join(data, "0.jpg"), os.path.join(data, "1.jpg")),
                      dataset_dir=data, output_dir=str(tmp_path / "out"), batch_size=2,
                      image_size=(32, 32), total_steps=2, num_workers=2,
                      monitor_image=os.path.join(data, "2.jpg"), monitor_every=2,
                      device="cpu")
    with pytest.warns(UserWarning, match="VGG19"):
        train_style_transfer(cfg)
    assert "saved 2 monitor samples at step 2" in capsys.readouterr().out
    for s in range(2):
        img = Image.open(tmp_path / "out" / f"sample_step_2_style{s}.jpg")
        assert img.size == (32, 32)


def test_cli_trains_onepass(tmp_path, capsys):
    data, out = str(tmp_path / "data"), str(tmp_path / "out")
    _images(data, 4, (36, 36), seed=3)
    with pytest.warns(UserWarning, match="VGG19"):
        final = begin_training.main(
            ["--device", "cpu", "--dataset_dir", data, "--style_image",
             os.path.join(data, "0.jpg"), "--output_dir", out, "--batch_size", "2",
             "--image_size", "32", "32", "--num_workers", "2", "--in_stats", "onepass",
             "--training_monitor_content_image", "", "--total_steps", "2"])
    assert "trained 2 steps" in capsys.readouterr().out
    assert num_styles(load_checkpoint(final)) == 1
