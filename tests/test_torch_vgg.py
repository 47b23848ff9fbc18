"""The port's VGG19, its weight loaders and the perceptual losses against
the JAX package's on the CPU.

VGG params are the JAX package's seeded init carried across with
``vgg_params_from_jax``; inputs come from a numpy seed. Tolerances (f32):
activations 1e-4 relative to the largest (up to 4,608 products per output,
summed in other orders, through up to 10 convs); losses 1e-5 relative.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_neural_style_transfer_tpu.losses import perceptual as jloss
from fast_neural_style_transfer_tpu.models import vgg as jvgg
from fast_neural_style_transfer_tpu.models import vgg_weights as jweights
from fast_neural_style_transfer_tpu_torch.losses import perceptual as tloss
from fast_neural_style_transfer_tpu_torch.models import vgg as tvgg
from fast_neural_style_transfer_tpu_torch.models import vgg_weights as tweights
from fast_neural_style_transfer_tpu_torch.ops import conv as tconv


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs with several xdist workers
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jax_vgg():
    return jax.tree.map(np.asarray, jvgg.VGG19Features.init(jax.random.PRNGKey(1)))


@pytest.fixture(scope="module")
def vgg(jax_vgg):
    return tweights.make_vgg(tweights.vgg_params_from_jax(jax_vgg), "cpu")


def _x(shape=(2, 32, 32, 3), seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, rel=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * np.abs(want).max())


@pytest.mark.parametrize("taps", [jvgg.DEFAULT_TAPS, ("relu4_2", "pool2", "conv1_1")])
def test_taps_match_jax(jax_vgg, vgg, taps):
    x = _x()
    want = jvgg.VGG19Features.apply(jax.tree.map(jnp.asarray, jax_vgg), jnp.asarray(x), taps)
    with torch.no_grad():
        got = vgg(torch.from_numpy(x), taps)
    assert len(got) == len(taps)
    for name, g, w in zip(taps, got, want):
        assert g.shape == w.shape, name
        assert g.is_contiguous()  # NHWC, a free view of channels_last
        _close(g.numpy(), w)
    if "conv4_2" in taps:  # pre-ReLU: negative values survive
        assert (got[taps.index("conv4_2")] < 0).any()


def test_walk_stops_at_the_deepest_tap(vgg, monkeypatch):
    calls = []
    real = tvgg.conv2d_same

    def counting(x, w, b, **kw):
        calls.append(tuple(w.shape))
        return real(x, w, b, **kw)

    monkeypatch.setattr(tvgg, "conv2d_same", counting)
    with torch.no_grad():
        vgg(torch.from_numpy(_x()), ("relu1_2",))
    assert calls == [(64, 3, 3, 3), (64, 64, 3, 3)]
    calls.clear()
    with torch.no_grad():
        vgg(torch.from_numpy(_x()), ("relu2_2", "conv4_2"))
    assert len(calls) == 10  # conv1_1 .. conv4_2
    with pytest.raises(ValueError, match="unknown VGG19 tap"):
        vgg(torch.from_numpy(_x()), ("relu9_9",))


def test_input_gradient_matches_jax(jax_vgg, vgg):
    """d(sum of taps . r)/dx through pools, ReLUs and the conv1_1 Function
    (plain backward on the CPU) against jax.vjp; VGG weights get none."""
    taps = ("relu1_2", "relu2_2", "conv4_2")
    x = _x(seed=1)
    outs_j, vjp = jax.vjp(
        lambda a: jvgg.VGG19Features.apply(jax.tree.map(jnp.asarray, jax_vgg), a, taps),
        jnp.asarray(x))
    rng = np.random.default_rng(2)
    cot = [rng.standard_normal(o.shape).astype(np.float32) for o in outs_j]
    (dx_j,) = vjp([jnp.asarray(c) for c in cot])
    xt = torch.from_numpy(x).requires_grad_()
    outs_t = vgg(xt, taps)
    (dx_t,) = torch.autograd.grad(outs_t, xt, [torch.from_numpy(c) for c in cot])
    _close(dx_t.numpy(), dx_j)
    assert all(not p.requires_grad for p in vgg.parameters())


def test_random_fallback_warns_and_is_deterministic(monkeypatch):
    monkeypatch.delenv("FNST_VGG19_WEIGHTS", raising=False)
    with pytest.warns(UserWarning, match="No pretrained VGG19 weights"):
        a = tweights.resolve_params(None, seed=3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        b = tweights.resolve_params(None, seed=3)
        c = tweights.resolve_params(None, seed=4)
    assert set(a) == {f"{n}.{k}" for n in tvgg.CONV_NAMES for k in ("weight", "bias")}
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv1_1.weight"], c["conv1_1.weight"])
    w = a["conv3_1.weight"]
    assert w.shape == (256, 128, 3, 3) and abs(w.std().item() - 0.05) < 0.002
    assert not a["conv3_1.bias"].any()


def test_npz_and_torchvision_files_load_like_jax(jax_vgg, tmp_path):
    sd = tweights.vgg_params_from_jax(jax_vgg)
    npz = str(tmp_path / "vgg.npz")
    jweights.save_npz(jax_vgg, npz)  # the JAX package's file format
    again = tweights.resolve_params(npz)
    assert all(torch.equal(again[k], sd[k]) for k in sd)
    # torchvision layouts: features.<i>.weight (full model) and <i>.weight
    tv = {k: torch.from_numpy(v) for k, v in jweights.to_torch_state_dict(jax_vgg).items()}
    pth = str(tmp_path / "vgg19.pth")
    torch.save(tv, pth)
    from_pth = tweights.resolve_params(pth)
    bare = tweights.from_torchvision_state_dict(
        {k.removeprefix("features."): v for k, v in tv.items()})
    for k in sd:
        assert torch.equal(from_pth[k], sd[k]) and torch.equal(bare[k], sd[k])
    with pytest.raises(FileNotFoundError):
        tweights.resolve_params(str(tmp_path / "missing.npz"))
    with pytest.raises(KeyError, match="missing layer"):
        tweights.from_torchvision_state_dict({})


# -- losses ---------------------------------------------------------------------


def _feats(seed, shapes=((2, 8, 8, 16), (2, 4, 4, 32), (2, 2, 2, 64))):
    rng = np.random.default_rng(seed)
    return [np.abs(rng.standard_normal(s)).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("masked", [False, True])
def test_losses_match_jax(masked):
    feats, style, content = _feats(3), _feats(4, ((1, 8, 8, 16), (1, 4, 4, 32),
                                                  (1, 2, 2, 64))), _feats(5)[2]
    img = np.random.default_rng(6).standard_normal((2, 10, 12, 3)).astype(np.float32)
    mask = np.asarray([1.0, 0.0], np.float32) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    grams_j = jloss.style_targets_from_features([jnp.asarray(f) for f in style])
    grams_t = tloss.style_targets_from_features([torch.from_numpy(f) for f in style])
    for g_t, g_j in zip(grams_t, grams_j):
        np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-5)
    weights = (0.25, 0.3, 0.45)
    s_j = jloss.style_loss([jnp.asarray(f) for f in feats], grams_j, weights, batch_mask=jm)
    s_t = tloss.style_loss([torch.from_numpy(f) for f in feats], grams_t, weights,
                           batch_mask=tm)
    c_j = jloss.content_loss(jnp.asarray(feats[2]), jnp.asarray(content), batch_mask=jm)
    c_t = tloss.content_loss(torch.from_numpy(feats[2]), torch.from_numpy(content),
                             batch_mask=tm)
    t_j = jloss.total_variation_loss(jnp.asarray(img), batch_mask=jm)
    t_t = tloss.total_variation_loss(torch.from_numpy(img), batch_mask=tm)
    for got, want in ((s_t, s_j), (c_t, c_j), (t_t, t_j)):
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


def test_masked_losses_equal_the_real_batch():
    feats = _feats(7)
    img = np.random.default_rng(8).standard_normal((2, 6, 6, 3)).astype(np.float32)
    mask = torch.tensor([1.0, 0.0])
    real = [torch.from_numpy(f[:1]) for f in feats]
    grams = tloss.style_targets_from_features(real)
    w = (0.25, 0.3, 0.45)
    both = [torch.from_numpy(f) for f in feats]
    assert torch.allclose(tloss.style_loss(both, grams, w, batch_mask=mask),
                          tloss.style_loss(real, grams, w))
    assert torch.allclose(tloss.total_variation_loss(torch.from_numpy(img), batch_mask=mask),
                          tloss.total_variation_loss(torch.from_numpy(img[:1])))


def test_loss_taps_and_unported_banks():
    with pytest.raises(ValueError, match="style taps but"):
        tloss.LossTaps(style_taps=("relu1_2",), style_weights=(0.5, 0.5))
    taps = tloss.LossTaps(content_tap="relu2_2")
    assert taps.all_taps == jloss.LossTaps(content_tap="relu2_2").all_taps
    assert tloss.REFERENCE_TAPS.all_taps == jloss.REFERENCE_TAPS.all_taps
    feats = [torch.zeros(1, 2, 2, 4)]
    with pytest.raises(ValueError, match="need style_select"):
        tloss.style_loss(feats, [torch.zeros(3, 4, 4)], (1.0,))


def test_small_cin_kernel_only_on_conv1_1(vgg, monkeypatch):
    """Only conv1_1 asks for the hand-written backward; it takes effect
    when the input needs a gradient."""
    seen = []
    real = tconv.Conv2dSameSmallCinFn.apply
    monkeypatch.setattr(tconv.Conv2dSameSmallCinFn, "apply",
                        lambda *a: seen.append(a[1].shape) or real(*a))
    xt = torch.from_numpy(_x(seed=3)).requires_grad_()
    vgg(xt, ("relu2_2",))
    assert seen == [(64, 3, 3, 3)]
    with torch.no_grad():
        vgg(xt, ("relu2_2",))
    assert seen == [(64, 3, 3, 3)]
