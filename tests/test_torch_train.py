"""The port's training path against the JAX package's on the CPU.

One synced float32 step at full width (B=2, 32x32, no dropout) from the same
stylizer params, VGG params and uint8 batch, against the JAX package's
``make_train_step(norm_method="xla")``: loss, gradients, updated params and
the step counter; then a ``grad_accum=2`` pair of micro-steps, and the
non-finite guard. Also the schedules, the optimizer against optax, the
training CLI and its artifact.

Tolerances: loss 1e-4 relative and gradients 1e-3 of the largest gradient
(f32 sums in other orders through ~30 convs and the Gram matrices).
Updated params: Adam's first update is lr * g / (|g| + 1e-8) with g the
clipped gradient plus 1e-5 * param; elements whose g lies within a few
hundred 1e-8 of zero swing with the last bits of g (by up to 2 lr), so
those with |g| >= 1e-4 must agree within 1e-3 lr and all within 2 lr.
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
from fast_neural_style_transfer_tpu.losses import style_targets_from_features as jax_targets
from fast_neural_style_transfer_tpu.models import TransformerNet as JaxNet
from fast_neural_style_transfer_tpu.models import VGG19Features as JaxVGG
from fast_neural_style_transfer_tpu.train import schedule as jsched
from fast_neural_style_transfer_tpu.train import state as jstate
from fast_neural_style_transfer_tpu.train import step as jstep
from fast_neural_style_transfer_tpu_torch.cli import begin_training
from fast_neural_style_transfer_tpu_torch.core.dtypes import Precision
from fast_neural_style_transfer_tpu_torch.losses import LossTaps, style_targets_from_features
from fast_neural_style_transfer_tpu_torch.models import TransformerNet, params_from_jax
from fast_neural_style_transfer_tpu_torch.models.vgg_weights import (
    make_vgg,
    vgg_params_from_jax,
)
from fast_neural_style_transfer_tpu_torch.models.weights import load_checkpoint
from fast_neural_style_transfer_tpu_torch.train import schedule as tsched
from fast_neural_style_transfer_tpu_torch.train.state import StyleOptimizer, create_train_state
from fast_neural_style_transfer_tpu_torch.train.step import loss_fn, make_train_step
from fast_neural_style_transfer_tpu_torch.utils.image_io import u8_to_network

LR, TOTAL = 1e-3, 100
HW = 32


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)  # the suite runs with several xdist workers
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    params = jax.tree.map(np.asarray, JaxNet.init(jax.random.PRNGKey(0)))
    vgg = jax.tree.map(np.asarray, JaxVGG.init(jax.random.PRNGKey(1)))
    batches = [rng.integers(0, 256, (2, HW, HW, 3), dtype=np.uint8) for _ in range(2)]
    style = rng.integers(0, 256, (1, HW, HW, 3), dtype=np.uint8)
    return {"params": params, "vgg": vgg, "batches": batches, "style": style}


def _jax_grams(s):
    x = jstep.normalize_u8_batch(jnp.asarray(s["style"]))
    feats = JaxVGG.apply(jax.tree.map(jnp.asarray, s["vgg"]), x, JaxTaps().style_taps)
    return tuple(jax_targets(feats))


def _jax_state(s, grad_accum):
    opt = jstate.make_optimizer(LR, TOTAL, grad_accum=grad_accum)
    step = jstep.make_train_step(opt, taps=JaxTaps(), precision=JaxPrecision.f32(), lr=LR,
                                 total_steps=TOTAL, grad_accum=grad_accum, donate=False,
                                 dropout=False, norm_method="xla")
    return jstate.create_train_state(jax.tree.map(jnp.asarray, s["params"]), opt), step


def _port(s, grad_accum=1):
    net = TransformerNet()
    net.load_state_dict(params_from_jax(s["params"]), strict=True)
    net = net.to(memory_format=torch.channels_last)
    vgg = make_vgg(vgg_params_from_jax(s["vgg"]), "cpu")
    style = u8_to_network(torch.from_numpy(s["style"]))
    with torch.no_grad():
        grams = style_targets_from_features(vgg(style, LossTaps().style_taps))
    state = create_train_state(net, LR, TOTAL, grad_accum=grad_accum)
    step = make_train_step(lr=LR, total_steps=TOTAL, grad_accum=grad_accum, dropout=False)
    return state, vgg, grams, step


@pytest.fixture(scope="module")
def jax_runs(setup):
    """The JAX side once: grads of the first batch, one step, two
    grad_accum=2 micro-steps, and a non-finite step."""
    s = setup
    vgg = jax.tree.map(jnp.asarray, s["vgg"])
    grams = _jax_grams(s)
    weights = jsched.LossWeightSchedule()(0)
    grad_fn = jax.jit(jax.grad(functools.partial(
        jstep.loss_fn, taps=JaxTaps(), precision=JaxPrecision.f32(), norm_method="xla"),
        has_aux=True))
    grads, _ = grad_fn(jax.tree.map(jnp.asarray, s["params"]), vgg,
                       jnp.asarray(s["batches"][0]), grams, weights, None)
    key = jax.random.PRNGKey(0)
    st, step = _jax_state(s, 1)
    one, m_one = step(st, vgg, jnp.asarray(s["batches"][0]), grams, key)
    nan_batch = np.zeros((2, HW, HW, 3), np.float32)
    nan_batch[0, 0, 0, 0] = np.nan
    skipped, m_nan = step(one, vgg, jnp.asarray(nan_batch), grams, key)
    st2, step2 = _jax_state(s, 2)
    acc1, _ = step2(st2, vgg, jnp.asarray(s["batches"][0]), grams, key)
    acc2, m_acc = step2(acc1, vgg, jnp.asarray(s["batches"][1]), grams, key)
    as_sd = lambda tree: params_from_jax(jax.tree.map(np.asarray, tree))
    return {"step": step, "vgg": vgg, "grams": grams, "grads": as_sd(grads),
            "one": (as_sd(one.params), int(one.step)),
            "m_one": jax.tree.map(float, m_one), "m_nan": jax.tree.map(float, m_nan),
            "skipped": (as_sd(skipped.params), int(skipped.step)),
            "acc1": (as_sd(acc1.params), int(acc1.step)),
            "acc2": (as_sd(acc2.params), int(acc2.step)), "m_acc": jax.tree.map(float, m_acc),
            "nan_batch": nan_batch}


def _effective_grads(grads, params, norm):
    scale = min(1.0, 1.0 / norm)
    return {k: (grads[k] * scale + 1e-5 * params[k]).abs() for k in grads}


def _assert_update_close(got, want, g_eff, lr=LR):
    for k in want:
        d = (got[k] - want[k]).abs() / lr
        assert d.max().item() <= 2, k
        firm = g_eff[k] >= 1e-4
        assert (d[firm] <= 1e-3).all(), (k, d[firm].max().item())


def _state_dict(state):
    return {k: v.detach().clone() for k, v in state.net.state_dict().items()}


def test_train_step_matches_jax(setup, jax_runs):
    state, vgg, grams, step = _port(setup)
    for g_t, g_j in zip(grams, jax_runs["grams"]):
        np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-4,
                                   atol=1e-4 * np.abs(np.asarray(g_j)).max())
    before = _state_dict(state)
    names = [n for n, _ in state.net.named_parameters()]
    total, _ = loss_fn(state.net, vgg, torch.from_numpy(setup["batches"][0]), grams,
                       tsched.LossWeightSchedule()(0), taps=LossTaps(),
                       precision=Precision.f32(), dropout=False)
    grads = dict(zip(names, torch.autograd.grad(total, list(state.net.parameters()))))
    gmax = max(np.abs(v.numpy()).max() for v in jax_runs["grads"].values())
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jax_runs["grads"][k].numpy(), rtol=0,
                                   atol=1e-3 * gmax, err_msg=k)
    m = step(state, vgg, torch.from_numpy(setup["batches"][0]), grams)
    want = jax_runs["m_one"]
    for key in ("loss", "content_loss", "style_loss", "tv_loss", "grad_norm"):
        np.testing.assert_allclose(float(m[key]), want[key], rtol=1e-4, err_msg=key)
    assert float(m["lr"]) == pytest.approx(want["lr"], rel=1e-7)
    assert float(m["skipped_nonfinite"]) == want["skipped_nonfinite"] == 0
    params_j, step_j = jax_runs["one"]
    assert state.step == step_j == 1
    _assert_update_close(_state_dict(state), params_j,
                         _effective_grads(grads, before, float(m["grad_norm"])))


def test_grad_accum_matches_multisteps(setup, jax_runs):
    state, vgg, grams, step = _port(setup, grad_accum=2)
    before = _state_dict(state)
    step(state, vgg, torch.from_numpy(setup["batches"][0]), grams)
    assert state.step == jax_runs["acc1"][1] == 1
    assert all(torch.equal(v, before[k]) for k, v in state.net.state_dict().items())
    m = step(state, vgg, torch.from_numpy(setup["batches"][1]), grams)
    params_j, step_j = jax_runs["acc2"]
    assert state.step == step_j == 2 and state.optimizer.applied == 1
    np.testing.assert_allclose(float(m["loss"]), jax_runs["m_acc"]["loss"], rtol=1e-4)
    # the update is made from the mean of the two micro-batches' gradients
    names = [n for n, _ in state.net.named_parameters()]
    probe = _port(setup)[0]
    gsum = None
    for b in setup["batches"]:
        total, _ = loss_fn(probe.net, vgg, torch.from_numpy(b), grams,
                           tsched.LossWeightSchedule()(0), taps=LossTaps(),
                           precision=Precision.f32(), dropout=False)
        g = torch.autograd.grad(total, list(probe.net.parameters()))
        gsum = g if gsum is None else [a + c for a, c in zip(gsum, g)]
    mean_g = dict(zip(names, [a / 2 for a in gsum]))
    norm = float(torch.sqrt(sum((v * v).sum() for v in mean_g.values())))
    _assert_update_close(_state_dict(state), params_j, _effective_grads(mean_g, before, norm))


def test_nonfinite_loss_skips_everything(setup, jax_runs):
    state, vgg, grams, step = _port(setup)
    step(state, vgg, torch.from_numpy(setup["batches"][0]), grams)
    before = _state_dict(state)
    opt_before = state.optimizer.state_dict()
    m = step(state, vgg, torch.from_numpy(jax_runs["nan_batch"]), grams)
    assert float(m["skipped_nonfinite"]) == jax_runs["m_nan"]["skipped_nonfinite"] == 1.0
    assert not np.isfinite(float(m["loss"])) and not np.isfinite(jax_runs["m_nan"]["loss"])
    assert state.step == jax_runs["skipped"][1] == 1
    assert all(torch.equal(v, before[k]) for k, v in state.net.state_dict().items())
    for k, v in jax_runs["skipped"][0].items():  # JAX also kept its params
        assert torch.equal(v, jax_runs["one"][0][k])
    opt_after = state.optimizer.state_dict()
    assert opt_after["applied"] == opt_before["applied"] == 1
    for idx, st in opt_before["adam"]["state"].items():
        for name, t in st.items():
            assert torch.equal(opt_after["adam"]["state"][idx][name], t)


def test_schedules_match_jax():
    for total, lr in ((1000, 1e-3), (7, 3e-4)):
        j, t = jsched.cosine_lr_schedule(lr, total), tsched.cosine_lr_schedule(lr, total)
        for step in (0, 1, 3, total // 2, total - 1, total, total + 5):
            assert t(step) == float(j(step)), (total, step)
    for sched, steps in (((1000.0, 1.0, 10.0, 10_000), (0, 9_999, 10_000, 25_000)),
                         ((5.0, 2.0, 1.0, 3), (0, 2, 3, 9, 31)),
                         ((1.0, 1.0, 1.0, 0), (0, 10_000))):
        j, t = jsched.LossWeightSchedule(*sched), tsched.LossWeightSchedule(*sched)
        for step in steps:
            assert t(step) == tuple(float(v) for v in j(step)), (sched, step)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_optimizer_matches_optax(grad_accum):
    """clip (triggered and not) -> decay -> Adam -> cosine, with and without
    gradient averaging, against make_optimizer's optax chain."""
    rng = np.random.default_rng(3)
    shapes = [(4, 3), (5,)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt_t = StyleOptimizer(params, 1e-2, 12, grad_accum=grad_accum)
    opt_j = jstate.make_optimizer(1e-2, 12, grad_accum=grad_accum)
    pj = [jnp.asarray(p) for p in p0]
    sj = opt_j.init(pj)
    for i in range(6):
        scale = 5.0 if i % 2 else 0.05  # global norm above and below 1
        g = [(rng.standard_normal(s) * scale).astype(np.float32) for s in shapes]
        moved = opt_t.update([torch.from_numpy(a) for a in g])
        upd, sj = opt_j.update([jnp.asarray(a) for a in g], sj, pj)
        pj = [a + u for a, u in zip(pj, upd)]
        assert moved == ((i + 1) % grad_accum == 0)
        for a, b in zip(params, pj):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=0, atol=1e-6)


def test_remat_and_dropout(setup):
    """remat recomputes the stylizer with the same dropout masks (the
    generator is rewound), so loss and gradients equal the plain pass;
    masks come from the generator and drop whole channels."""
    state, vgg, grams, _ = _port(setup)
    net = state.net.train()
    prec = Precision.f32()
    batch = torch.from_numpy(setup["batches"][0])
    out = []
    for remat in (False, True):
        gen = torch.Generator().manual_seed(7)
        total, _ = loss_fn(net, vgg, batch, grams, (1000.0, 1.0, 10.0), taps=LossTaps(),
                           precision=prec, generator=gen, remat=remat)
        out.append((total.item(), torch.autograd.grad(total, list(net.parameters()))))
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-6)
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6 * float(a.abs().max()) + 1e-12)
    x = u8_to_network(batch)
    with torch.no_grad():
        y1 = net(x, generator=torch.Generator().manual_seed(1))
        y2 = net(x, generator=torch.Generator().manual_seed(1))
        y3 = net(x, generator=torch.Generator().manual_seed(2))
        y0 = net(x, dropout=False)
        ye = net.eval()(x)
    assert torch.equal(y1, y2) and not torch.equal(y1, y3)
    assert torch.equal(y0, ye) and not torch.equal(y0, y1)


def _images(root, n, hw, seed):
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (*hw, 3), dtype=np.uint8)).save(
            os.path.join(root, f"{i}.jpg"))


def test_cli_writes_an_npz_the_jax_package_reads(tmp_path, capsys):
    data, out = str(tmp_path / "data"), str(tmp_path / "out")
    _images(data, 5, (40, 44), seed=1)
    _images(str(tmp_path / "s"), 1, (36, 36), seed=2)
    style = str(tmp_path / "s" / "0.jpg")
    args = ["--device", "cpu", "--dataset_dir", data, "--style_image", style,
            "--output_dir", out, "--batch_size", "2", "--image_size", "32", "32",
            "--num_workers", "2", "--training_monitor_content_image", ""]
    final = begin_training.main(args + ["--total_steps", "3"])
    assert final == os.path.join(out, "style_transfer_final.npz")
    ours = load_checkpoint(final)
    theirs = params_from_jax(jax.tree.map(np.asarray, JaxStylizer.load_params(final)))
    assert set(ours) == set(theirs)
    for k in ours:
        assert torch.equal(ours[k], theirs[k]), k
    assert sorted(os.listdir(os.path.join(out, "checkpoints"))) == [
        "ckpt_00000003.pt", "latest"]
    # a second run resumes from the checkpoint and takes one more step
    capsys.readouterr()
    begin_training.main(args + ["--total_steps", "4"])
    text = capsys.readouterr().out
    assert "resumed from checkpoint 3" in text and "trained 1 steps" in text
    assert not torch.equal(load_checkpoint(final)["conv1.conv.weight"],
                           ours["conv1.conv.weight"])


def test_cli_unported_options_exit(tmp_path):
    """--spatial trains (tests/test_torch_spatial_train.py); what the JAX
    loop refuses with it, the port's refuses before any rank starts."""
    base = ["--device", "cpu", "--dataset_dir", str(tmp_path), "--output_dir",
            str(tmp_path / "o"), "--style_image", "s.jpg", "--spatial", "2"]
    for flags, match in ((["--in_stats", "onepass"], "onepass"),
                         (["--image_size", "40", "40"], "must divide 8 \\* spatial"),
                         (["--style_image", "a.jpg", "b.jpg"], "multi-style"),
                         (["--pad_batch"], "pad_batch")):
        with pytest.raises(ValueError, match=match):
            begin_training.main(base + flags)


# -- row 6: full resume from a reference training .pth -------------------------


def _torch_adam_checkpoint(path, iteration=2, seed=11):
    """A reference training .pth as the reference trainer writes it: the
    port's TransformerNet (PyTorch-default init) and torch.optim.Adam with
    the reference's settings, stepped ``iteration`` times on seeded
    gradients."""
    torch.manual_seed(seed)
    net = TransformerNet()
    opt = torch.optim.Adam(net.parameters(), lr=LR, betas=(0.9, 0.999), eps=1e-8,
                           weight_decay=1e-5)
    rng = np.random.default_rng(seed)
    for _ in range(iteration):
        for p in net.parameters():
            p.grad = torch.from_numpy(
                (rng.standard_normal(p.shape) * 1e-2).astype(np.float32))
        opt.step()
    torch.save({"model_state_dict": net.state_dict(),
                "optimizer_state_dict": opt.state_dict(),
                "scheduler_state_dict": {"last_epoch": iteration,
                                         "_step_count": iteration + 1},
                "iteration": iteration}, path)
    return path


def _jax_saver_checkpoint(path, params, iteration=7, seed=12):
    """The same layout from the JAX package's save_torch_training_checkpoint,
    with seeded moments."""
    from fast_neural_style_transfer_tpu.export.torch_convert import (
        save_torch_training_checkpoint,
    )

    rng = np.random.default_rng(seed)
    mu = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32) * 1e-3, params)
    nu = jax.tree.map(lambda a: np.abs(rng.standard_normal(a.shape)).astype(np.float32) * 1e-6,
                      params)
    save_torch_training_checkpoint(params, mu, nu, iteration, iteration, path)
    return path


def _port_moments(state):
    names = [n for n, _ in state.net.named_parameters()]
    adam = state.optimizer.adam.state
    return ({n: adam[p]["exp_avg"] for n, p in zip(names, state.net.parameters())},
            {n: adam[p]["exp_avg_sq"] for n, p in zip(names, state.net.parameters())},
            {float(adam[p]["step"]) for p in state.net.parameters()})


@pytest.mark.parametrize("grad_accum", [1, 2])
@pytest.mark.parametrize("source", ["torch_adam", "jax_saver"])
def test_reference_checkpoint_restores_like_jax(setup, tmp_path, source, grad_accum):
    """state_from_reference_checkpoint against the JAX package's: params,
    Adam's moments, the bias-correction / schedule count and the step, bit
    for bit (the same transposes of the same numbers)."""
    from fast_neural_style_transfer_tpu_torch.train.state import (
        is_reference_training_checkpoint,
        state_from_reference_checkpoint,
    )

    path = str(tmp_path / "ref.pth")
    if source == "torch_adam":
        _torch_adam_checkpoint(path)
    else:
        _jax_saver_checkpoint(path, setup["params"])
    assert is_reference_training_checkpoint(path)
    bare = str(tmp_path / "bare.pth")
    torch.save(TransformerNet().state_dict(), bare)
    assert not is_reference_training_checkpoint(bare)
    assert not is_reference_training_checkpoint(str(tmp_path))
    ours = state_from_reference_checkpoint(path, TransformerNet(), LR, TOTAL,
                                           grad_accum=grad_accum)
    theirs = jstate.state_from_reference_checkpoint(
        path, jstate.make_optimizer(LR, TOTAL, grad_accum=grad_accum), grad_accum=grad_accum)
    mu_j, nu_j, count_j = jstate.extract_adam_moments(theirs.opt_state)
    as_sd = lambda tree: params_from_jax(jax.tree.map(np.asarray, tree))
    mu_t, nu_t, counts = _port_moments(ours)
    for got, want in ((_state_dict(ours), as_sd(theirs.params)), (mu_t, as_sd(mu_j)),
                      (nu_t, as_sd(nu_j))):
        assert set(got) == set(want)
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    assert counts == {float(count_j)} and ours.optimizer.applied == count_j
    assert ours.step == int(theirs.step) == (2 if source == "torch_adam" else 7) * grad_accum
    assert ours.optimizer.mini_step == 0 and ours.optimizer.acc is None


def test_resumed_step_matches_jax(setup, jax_runs, tmp_path):
    """One step from a resumed torch-Adam checkpoint on each side (the JAX
    step is the one jax_runs compiled): the loss, and the update, as
    test_train_step_matches_jax holds it."""
    from fast_neural_style_transfer_tpu_torch.train.state import state_from_reference_checkpoint

    path = _torch_adam_checkpoint(str(tmp_path / "ref.pth"))
    theirs = jstate.state_from_reference_checkpoint(path, jstate.make_optimizer(LR, TOTAL))
    after_j, m_j = jax_runs["step"](theirs, jax_runs["vgg"], jnp.asarray(setup["batches"][0]),
                                    jax_runs["grams"], jax.random.PRNGKey(0))
    state, vgg, grams, step = _port(setup)
    state = state_from_reference_checkpoint(path, state.net, LR, TOTAL)
    before = _state_dict(state)
    names = [n for n, _ in state.net.named_parameters()]
    total, _ = loss_fn(state.net, vgg, torch.from_numpy(setup["batches"][0]), grams,
                       tsched.LossWeightSchedule()(2), taps=LossTaps(),
                       precision=Precision.f32(), dropout=False)
    grads = dict(zip(names, torch.autograd.grad(total, list(state.net.parameters()))))
    m = step(state, vgg, torch.from_numpy(setup["batches"][0]), grams)
    np.testing.assert_allclose(float(m["loss"]), float(m_j["loss"]), rtol=1e-4)
    assert float(m["lr"]) == pytest.approx(float(m_j["lr"]), rel=1e-7)
    assert state.step == int(after_j.step) == 3 and state.optimizer.applied == 3
    _assert_update_close(_state_dict(state),
                         params_from_jax(jax.tree.map(np.asarray, after_j.params)),
                         _effective_grads(grads, before, float(m["grad_norm"])))


def test_reference_training_checkpoint_resumes_in_the_loop(tmp_path, capsys):
    from fast_neural_style_transfer_tpu_torch.train.loop import TrainConfig, train_style_transfer

    _images(str(tmp_path / "d"), 3, (32, 32), seed=3)
    ref = _torch_adam_checkpoint(str(tmp_path / "ref.pth"), iteration=2)
    style = str(tmp_path / "d" / "0.jpg")
    cfg = TrainConfig(style_image=style, dataset_dir=str(tmp_path / "d"),
                      output_dir=str(tmp_path / "o"), batch_size=2, image_size=(32, 32),
                      total_steps=3, num_workers=2, init_checkpoint=ref, device="cpu")
    with pytest.warns(UserWarning, match="VGG19"):
        train_style_transfer(cfg)
    text = capsys.readouterr().out
    assert f"fully resumed reference training checkpoint {ref} at iteration 2" in text
    assert "trained 1 steps" in text
    multi = TrainConfig(style_image=(style, str(tmp_path / "d" / "1.jpg")),
                        dataset_dir=str(tmp_path / "d"), output_dir=str(tmp_path / "o2"),
                        batch_size=2, image_size=(32, 32), init_checkpoint=ref, device="cpu")
    with pytest.warns(UserWarning), pytest.raises(ValueError, match="single-style"):
        train_style_transfer(multi)
    with pytest.raises(ValueError, match="multiple of 4"):
        train_style_transfer(TrainConfig(style_image="s.jpg", dataset_dir=".",
                                         image_size=(30, 32), device="cpu"))


def test_bf16_step_keeps_f32_grads(setup):
    """bf16 compute, f32 params: the casts to the compute dtype pass the
    gradients back as f32, and they point where the f32 step's do: cosine
    > 0.95 (0.99 here: bf16 keeps ~3 significant digits per op through ~30
    layers; a dropped or misrouted gradient would give ~0)."""
    state, vgg, grams, _ = _port(setup)
    params = list(state.net.parameters())
    batch = torch.from_numpy(setup["batches"][0])
    flat = {}
    for name, prec in (("f32", Precision.f32()), ("bf16", Precision.bf16())):
        total, _ = loss_fn(state.net, vgg, batch, grams, (1000.0, 1.0, 10.0),
                           taps=LossTaps(), precision=prec, dropout=False)
        grads = torch.autograd.grad(total, params)
        assert all(g.dtype == torch.float32 and torch.isfinite(g).all() for g in grads)
        flat[name] = torch.cat([g.flatten() for g in grads])
    cos = torch.nn.functional.cosine_similarity(flat["f32"], flat["bf16"], dim=0)
    assert cos.item() > 0.95


def test_sigterm_drains_and_profiler_traces(tmp_path, monkeypatch, capsys):
    """SIGTERM during step 2 finishes that step, then the loop stops and
    leaves a checkpoint at 2 and the final .npz; steps [1, 2) are traced
    with torch.profiler into <output_dir>/profile."""
    import signal

    from fast_neural_style_transfer_tpu_torch.train import loop

    real = loop.make_train_step

    def make_step(**kw):
        step = real(**kw)

        def wrapped(state, *a, **k):
            out = step(state, *a, **k)
            if state.step == 2:  # what a SIGTERM does: run the loop's handler
                signal.getsignal(signal.SIGTERM)(signal.SIGTERM, None)
            return out

        return wrapped

    monkeypatch.setattr(loop, "make_train_step", make_step)
    data, out = str(tmp_path / "data"), str(tmp_path / "out")
    _images(data, 4, (36, 36), seed=4)
    before = signal.getsignal(signal.SIGTERM)
    cfg = loop.TrainConfig(style_image=os.path.join(data, "0.jpg"), dataset_dir=data,
                           output_dir=out, batch_size=2, image_size=(32, 32),
                           total_steps=10, num_workers=2, profile_start=1,
                           profile_stop=2, device="cpu")
    with pytest.warns(UserWarning, match="VGG19"):
        final = loop.train_style_transfer(cfg)
    text = capsys.readouterr().out
    assert "SIGTERM received" in text and "trained 2 steps" in text
    assert sorted(os.listdir(os.path.join(out, "checkpoints"))) == [
        "ckpt_00000002.pt", "latest"]
    assert os.path.exists(final)
    assert os.path.getsize(os.path.join(out, "profile", "trace.json")) > 0
    assert signal.getsignal(signal.SIGTERM) is before  # handler restored
