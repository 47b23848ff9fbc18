"""The port's height-sharded training against the JAX package's on the CPU
(ROADMAP row 15a).

Full width (B=2, 32x32, no dropout), the same stylizer params, VGG params,
uint8 batches and style Grams on both sides. The port's step runs in 2 and
4 gloo ranks (``tests/torch_spatial_ranks.py``); the JAX side on its host
mesh: ``spatial_loss_fn`` under shard_map, the unsharded gradients, and
``make_spatial_train_step``. Tolerances are JAX's own
(``tests/test_spatial_train.py``): loss 1e-4 relative, the other metrics
1e-3 (the gradient norm, 1e6 with the random VGG, sums the roundoff of
the conv biases ahead of each IN, whose true gradient is 0), params after a step
2.5e-3 absolute (Adam's first update moves an element whose gradient is
~0 by up to 2 lr = 2e-3 either way), gradients 1e-3 of the largest (as
``tests/test_torch_train.py``).
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from PIL import Image

import torch_spatial_ranks as ranks
from fast_neural_style_transfer_tpu.core.dtypes import Precision as JaxPrecision
from fast_neural_style_transfer_tpu.losses import LossTaps as JaxTaps
from fast_neural_style_transfer_tpu.losses import style_targets_from_features as jax_targets
from fast_neural_style_transfer_tpu.models import TransformerNet as JaxNet
from fast_neural_style_transfer_tpu.models import VGG19Features as JaxVGG
from fast_neural_style_transfer_tpu.parallel import make_mesh_plan as jax_mesh_plan
from fast_neural_style_transfer_tpu.parallel.mesh import shard_map_checked
from fast_neural_style_transfer_tpu.train import schedule as jsched
from fast_neural_style_transfer_tpu.train import state as jstate
from fast_neural_style_transfer_tpu.train import step as jstep
from fast_neural_style_transfer_tpu.train.spatial_step import (
    make_spatial_train_step as jax_spatial_step,
)
from fast_neural_style_transfer_tpu.train.spatial_step import spatial_loss_fn as jax_loss
from fast_neural_style_transfer_tpu_torch.models import params_from_jax
from fast_neural_style_transfer_tpu_torch.models.vgg_weights import make_vgg, vgg_params_from_jax
from fast_neural_style_transfer_tpu_torch.parallel import launch
from fast_neural_style_transfer_tpu_torch.train.loop import TrainConfig, train_style_transfer
from fast_neural_style_transfer_tpu_torch.train.state import create_train_state
from fast_neural_style_transfer_tpu_torch.train.step import make_train_step

LR, TOTAL, HW = 1e-3, 100, 32
DEADLINE = 120.0
ROWS = P(None, "space", None, None)


@functools.lru_cache(maxsize=None)
def _setup():
    rng = np.random.default_rng(0)
    params = jax.tree.map(np.asarray, JaxNet.init(jax.random.PRNGKey(0)))
    vgg = jax.tree.map(np.asarray, JaxVGG.init(jax.random.PRNGKey(1)))
    batches = [rng.integers(0, 256, (2, HW, HW, 3), dtype=np.uint8) for _ in range(2)]
    style = rng.integers(0, 256, (1, HW, HW, 3), dtype=np.uint8)
    feats = JaxVGG.apply(jax.tree.map(jnp.asarray, vgg),
                         jstep.normalize_u8_batch(jnp.asarray(style)), JaxTaps().style_taps)
    grams = [np.asarray(g) for g in jax_targets(feats)]
    port = {k: v.numpy() for k, v in params_from_jax(params).items()}
    port_vgg = {k: v.numpy() for k, v in vgg_params_from_jax(vgg).items()}
    return {"params": params, "vgg": vgg, "batches": batches, "grams": grams,
            "port": port, "port_vgg": port_vgg}


@functools.lru_cache(maxsize=None)
def _jax_loss(n: int) -> dict:
    s = _setup()
    mesh = jax_mesh_plan(spatial=n).mesh
    fn = functools.partial(jax_loss, taps=JaxTaps(), precision=JaxPrecision.f32())
    mapped = jax.jit(shard_map_checked(
        lambda p, v, b, g, w: fn(p, v, b, g, w, None)[1], mesh,
        in_specs=(P(), P(), ROWS, P(), P()), out_specs=P(), check=False))
    m = mapped(jax.tree.map(jnp.asarray, s["params"]), jax.tree.map(jnp.asarray, s["vgg"]),
               jnp.asarray(s["batches"][0]), tuple(jnp.asarray(g) for g in s["grams"]),
               jsched.LossWeightSchedule()(0))
    return jax.tree.map(float, m)


@functools.lru_cache(maxsize=None)
def _jax_grads() -> dict:
    """The unsharded gradients (JAX's own tests hold its sharded ones to
    them)."""
    s = _setup()
    grad_fn = jax.jit(jax.grad(functools.partial(
        jstep.loss_fn, taps=JaxTaps(), precision=JaxPrecision.f32(), norm_method="xla"),
        has_aux=True))
    grads, _ = grad_fn(jax.tree.map(jnp.asarray, s["params"]),
                       jax.tree.map(jnp.asarray, s["vgg"]), jnp.asarray(s["batches"][0]),
                       tuple(jnp.asarray(g) for g in s["grams"]),
                       jsched.LossWeightSchedule()(0), None)
    return {k: v.numpy() for k, v in params_from_jax(jax.tree.map(np.asarray, grads)).items()}


@functools.lru_cache(maxsize=None)
def _jax_step(n: int):
    s = _setup()
    opt = jstate.make_optimizer(LR, TOTAL)
    # a (1, n) (data, space) mesh: the port's data degree is 1
    plan = jax_mesh_plan(jax.devices()[:n], spatial=n)
    step = jax_spatial_step(opt, plan, taps=JaxTaps(), lr=LR,
                            total_steps=TOTAL, donate=False)
    st = jstate.create_train_state(jax.tree.map(jnp.asarray, s["params"]), opt)
    new, m = step(st, jax.tree.map(jnp.asarray, s["vgg"]), jnp.asarray(s["batches"][0]),
                  tuple(jnp.asarray(g) for g in s["grams"]), None)
    params = {k: v.numpy() for k, v in
              params_from_jax(jax.tree.map(np.asarray, new.params)).items()}
    return params, int(new.step), jax.tree.map(float, m)


@functools.lru_cache(maxsize=None)
def _port(n: int, remat: bool = False) -> list:
    s = _setup()
    return launch(ranks.train, n, (s["port"], s["port_vgg"], s["batches"], s["grams"],
                                   LR, TOTAL, remat), deadline_s=DEADLINE, quiet=True, device="cpu")


@functools.lru_cache(maxsize=None)
def _port_unsharded():
    """The port's unsharded step on the same inputs (its parity with JAX is
    ``tests/test_torch_train.py``'s)."""
    s = _setup()
    net = ranks.load_net(s["port"], "cpu")
    vgg = make_vgg(ranks.state_dict(s["port_vgg"]), "cpu")
    state = create_train_state(net, LR, TOTAL)
    m = make_train_step(lr=LR, total_steps=TOTAL, dropout=False)(
        state, vgg, torch.from_numpy(s["batches"][0]), [torch.from_numpy(g) for g in s["grams"]])
    return ({k: v.detach().numpy() for k, v in state.net.state_dict().items()},
            {k: float(v) for k, v in m.items()})


@pytest.mark.parametrize("n", [2, 4])
def test_spatial_loss_matches_jax(n):
    got, want = _port(n)[0]["loss"], _jax_loss(n)
    for key in ("loss", "content_loss", "style_loss", "tv_loss"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, err_msg=key)
    for r in _port(n)[1:]:  # the global loss on every rank alike
        assert r["loss"] == _port(n)[0]["loss"]


@pytest.mark.parametrize("n", [2, 4])
def test_spatial_gradients_match_jax(n):
    got, want = _port(n)[0]["grads"], _jax_grads()
    gmax = max(np.abs(v).max() for v in want.values())
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-3 * gmax, err_msg=k)


@pytest.mark.parametrize("n", [2, 4])
def test_replicated_loss_gradient_is_not_scaled_by_ranks(n):
    """Each rank backpropagates the same global loss. With an all-reduce
    backward on the loss's sums, or dgamma / dbeta all-reduced inside the
    IN as well as after, the summed gradient would come out n times (or,
    for the IN affines, more) too large: check the norm of every
    parameter's gradient against JAX's, and that the ranks' shares differ
    (each holds its own part, not the whole)."""
    out = _port(n)
    want = _jax_grads()
    top = max(np.linalg.norm(v) for v in want.values())
    for k in want:
        if np.linalg.norm(want[k]) < 1e-3 * top:
            continue  # the conv biases ahead of an IN: gradient ~0, roundoff only
        ratio = np.linalg.norm(out[0]["grads"][k]) / np.linalg.norm(want[k])
        assert abs(ratio - 1.0) < 1e-2, (k, ratio)
        share = sum(r["grads_local"][k] for r in out)
        np.testing.assert_allclose(share, out[0]["grads"][k], rtol=1e-5,
                                   atol=1e-6 * np.abs(want[k]).max())
    k = "norm1.weight"
    assert not np.allclose(out[0]["grads_local"][k], out[1]["grads_local"][k])


@pytest.mark.parametrize("n", [2, 4])
def test_spatial_step_matches_jax_and_unsharded(n):
    metrics, step, params = _port(n)[0]["steps"][0]
    want_params, want_step, want_m = _jax_step(n)
    assert step == want_step == 1
    np.testing.assert_allclose(metrics["loss"], want_m["loss"], rtol=1e-4)
    for key in ("content_loss", "style_loss", "tv_loss", "grad_norm", "lr"):
        np.testing.assert_allclose(metrics[key], want_m[key], rtol=1e-3, err_msg=key)
    assert metrics["skipped_nonfinite"] == want_m["skipped_nonfinite"] == 0
    flat, flat_m = _port_unsharded()
    np.testing.assert_allclose(metrics["loss"], flat_m["loss"], rtol=1e-4)
    for k in want_params:
        np.testing.assert_allclose(params[k], want_params[k], rtol=0, atol=2.5e-3, err_msg=k)
        np.testing.assert_allclose(params[k], flat[k], rtol=0, atol=2.5e-3, err_msg=k)


@pytest.mark.parametrize("n", [2, 4])
def test_params_equal_across_ranks_after_two_steps(n):
    out = _port(n)
    for i in range(2):
        ref = out[0]["steps"][i][2]
        for r in out[1:]:
            assert r["steps"][i][1] == i + 1
            for k in ref:
                np.testing.assert_array_equal(r["steps"][i][2][k], ref[k], err_msg=k)


def test_spatial_remat_step_matches_baseline():
    """Recomputing the stylizer and the VGG in the backward runs their
    exchanges again on every rank alike and gives the same step."""
    base, remat = _port(2)[0], _port(2, True)[0]
    np.testing.assert_allclose(remat["loss"]["loss"], base["loss"]["loss"], rtol=1e-6)
    for k in base["steps"][0][2]:
        np.testing.assert_allclose(remat["steps"][0][2][k], base["steps"][0][2][k],
                                   rtol=0, atol=2.5e-3, err_msg=k)


def _write_dataset(d, n, seed):
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (40, 40, 3), dtype=np.uint8)).save(
            os.path.join(d, f"img_{i}.png"))
    return d


def test_spatial_training_loop(tmp_path):
    """``train_style_transfer(spatial=2)`` outside a process group spawns the
    ranks; rank 0 alone logs and writes checkpoints and the final params."""
    data = _write_dataset(str(tmp_path / "data"), 4, 1)
    style = os.path.join(_write_dataset(str(tmp_path / "style"), 1, 2), "img_0.png")
    out = str(tmp_path / "out")
    cfg = TrainConfig(style_image=style, dataset_dir=data, output_dir=out,
                      total_steps=2, batch_size=2, image_size=(32, 32), log_every=1,
                      checkpoint_every=1, num_workers=1, device="cpu", spatial=2)
    final = train_style_transfer(cfg)
    assert final == os.path.join(out, "style_transfer_final.npz") and os.path.exists(final)
    with open(os.path.join(out, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert [r["step"] for r in lines] == [1, 2]
    assert all(np.isfinite(r["loss"]) and r["skipped_nonfinite"] == 0 for r in lines)
    assert sorted(os.listdir(os.path.join(out, "checkpoints"))) == [
        "ckpt_00000001.pt", "ckpt_00000002.pt", "latest"]
