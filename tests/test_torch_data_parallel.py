"""The port's data parallelism against the JAX package on the CPU.

The port splits a batch over gloo CPU ranks (``parallel.launch``; the
ranks' side is ``tests/torch_spatial_ranks.py``) or over replicas in one
process (``make_mesh_plan(devices=["cpu", "cpu"])``); the JAX package runs
the same inputs on one device or on its host mesh. Inputs come from a
numpy seed; dropout is off.

Tolerances: the JAX package's own for its data-parallel step
(``tests/test_parallel.py``): loss 1e-5 relative, and params after a step
within 3e-4 of the port's one-process step on the same global batch. Held
against JAX itself, params follow ``tests/test_torch_train.py``'s rule
(Adam's first update swings an element whose gradient is ~0 by up to 2
lr: all within 2 lr, those with |g| >= 1e-4 within 1e-3 lr), gradients
within 1e-3 of the largest, the other metrics 1e-4 relative (grad_norm
1e-3: it sums the roundoff of the conv biases ahead of each IN). The 2 x 2
(data x space) step takes ``tests/test_torch_spatial_train.py``'s bounds.
Serving: f32 within one u8 level of JAX, int8 (the trained checkpoint) a
mean |du8| <= 0.5 (``tests/test_torch_quantized.py``), and the replicas'
output equal, bit for bit, to the one-device Stylizer's.
"""

import functools
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

import torch_spatial_ranks as ranks
from fast_neural_style_transfer_tpu.core.dtypes import Precision as JaxPrecision
from fast_neural_style_transfer_tpu.data.dataset import ImageFolderDataset as JaxDataset
from fast_neural_style_transfer_tpu.data.pipeline import InputPipeline as JaxPipeline
from fast_neural_style_transfer_tpu.infer.adain import ArbitraryStylizer as JaxArbitrary
from fast_neural_style_transfer_tpu.infer.stylize import Stylizer as JaxStylizer
from fast_neural_style_transfer_tpu.losses import LossTaps as JaxTaps
from fast_neural_style_transfer_tpu.losses import style_targets_from_features as jax_targets
from fast_neural_style_transfer_tpu.models import TransformerNet as JaxNet
from fast_neural_style_transfer_tpu.models import VGG19Features as JaxVGG
from fast_neural_style_transfer_tpu.models.adain import AdaINDecoder as JaxDecoder
from fast_neural_style_transfer_tpu.parallel import make_mesh_plan as jax_mesh_plan
from fast_neural_style_transfer_tpu.parallel.mesh import place_on_data_axis as jax_place
from fast_neural_style_transfer_tpu.train import adain as jadain
from fast_neural_style_transfer_tpu.train import schedule as jsched
from fast_neural_style_transfer_tpu.train import state as jstate
from fast_neural_style_transfer_tpu.train import step as jstep
from fast_neural_style_transfer_tpu.train.spatial_step import (
    make_spatial_train_step as jax_spatial_step,
)
from fast_neural_style_transfer_tpu_torch.data import ImageFolderDataset, InputPipeline
from fast_neural_style_transfer_tpu_torch.infer import Stylizer, stylize_directory
from fast_neural_style_transfer_tpu_torch.infer.adain import (
    ArbitraryStylizer,
    stylize_directory_arbitrary,
)
from fast_neural_style_transfer_tpu_torch.models import load_checkpoint, params_from_jax
from fast_neural_style_transfer_tpu_torch.models.adain import (
    decoder_params_from_jax,
    save_decoder_npz,
)
from fast_neural_style_transfer_tpu_torch.models.vgg_weights import make_vgg, vgg_params_from_jax
from fast_neural_style_transfer_tpu_torch.parallel import launch, make_mesh_plan, place_on_data_axis
from fast_neural_style_transfer_tpu_torch.train.adain import AdaINTrainConfig
from fast_neural_style_transfer_tpu_torch.train.loop import TrainConfig
from fast_neural_style_transfer_tpu_torch.train.state import create_train_state
from fast_neural_style_transfer_tpu_torch.train.step import make_train_step

LR, TOTAL, HW = 1e-3, 100, 32
DEADLINE = 180.0
CHECKPOINT = Path(__file__).resolve().parents[1] / "evidence" / "soak40k_r5" / \
    "style_transfer_final.pth"


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)  # the suite runs with several xdist workers
    yield
    torch.set_num_threads(prev)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_params(tree) -> dict:
    return {k: v.numpy() for k, v in params_from_jax(_np(tree)).items()}


def _write_images(d, n, seed, size=(40, 40)):
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (*size, 3), dtype=np.uint8)).save(
            os.path.join(d, f"img_{i}.png"))
    return d


@functools.lru_cache(maxsize=None)
def _setup() -> dict:
    rng = np.random.default_rng(0)
    params = _np(JaxNet.init(jax.random.PRNGKey(0)))
    multi = _np(JaxNet.init(jax.random.PRNGKey(2), num_styles=2))
    multi = jax.tree.map(  # IN bank rows that differ, so each example's style matters
        lambda a: (a + rng.normal(scale=0.1, size=a.shape).astype(np.float32)
                   if a.ndim == 2 and a.shape[0] == 2 else a), multi)
    vgg = _np(JaxVGG.init(jax.random.PRNGKey(1)))
    batches = [rng.integers(0, 256, (4, HW, HW, 3), dtype=np.uint8) for _ in range(2)]
    real = rng.integers(0, 256, (6, HW, HW, 3), dtype=np.uint8)
    # JAX's per-shard padding of a global batch of 6 on 2 shards to 4 each
    padded = np.concatenate([real[:3], real[2:3], real[3:], real[5:]])
    mask = np.array([1, 1, 1, 0, 1, 1, 1, 0], np.float32)
    styles = rng.integers(0, 256, (2, 1, HW, HW, 3), dtype=np.uint8)
    jvgg = jax.tree.map(jnp.asarray, vgg)
    grams = [[np.asarray(g) for g in jax_targets(JaxVGG.apply(
        jvgg, jstep.normalize_u8_batch(jnp.asarray(s)), JaxTaps().style_taps))]
        for s in styles]
    decoder = _np(JaxDecoder.init(jax.random.PRNGKey(3)))
    return {"params": params, "multi": multi, "vgg": vgg, "batches": batches,
            "padded": padded, "mask": mask, "grams": grams[0],
            "grams_multi": [np.stack(layer) for layer in zip(*grams)],
            "select": np.eye(2, dtype=np.float32)[[0, 1, 1, 0]], "decoder": decoder,
            "content": rng.integers(0, 256, (4, HW, HW, 3), dtype=np.uint8),
            "style": rng.integers(0, 256, (4, HW, HW, 3), dtype=np.uint8)}


@pytest.fixture(scope="module")
def loop_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_loop")
    data = _write_images(str(root / "data"), 8, 1)
    style = os.path.join(_write_images(str(root / "style"), 1, 2), "img_0.png")
    styles = _write_images(str(root / "styles"), 4, 3)
    return data, style, str(root / "out"), styles, str(root / "adain_out")


@pytest.fixture(scope="module")
def dp(loop_dirs):
    """One launch of two ranks (data 2 x space 1): every data-parallel
    check's port side (``torch_spatial_ranks.data_parallel``)."""
    s = _setup()
    data, style, out, styles, adain_out = loop_dirs
    cfg = TrainConfig(style_image=style, dataset_dir=data, output_dir=out, total_steps=2,
                      batch_size=4, image_size=(HW, HW), log_every=1, checkpoint_every=1,
                      num_workers=1, device="cpu")
    adain_cfg = AdaINTrainConfig(content_dir=data, style_dir=styles, output_dir=adain_out,
                                 total_steps=2, batch_size=2, image_size=(HW, HW),
                                 log_every=1, num_workers=1, device="cpu")
    a = {"lr": LR, "total": TOTAL, "params": _port_params(s["params"]),
         "params_multi": _port_params(s["multi"]),
         "vgg": {k: v.numpy() for k, v in vgg_params_from_jax(s["vgg"]).items()},
         "batches": s["batches"], "padded": s["padded"], "mask": s["mask"],
         "grams": s["grams"], "grams_multi": s["grams_multi"], "select": s["select"],
         "decoder": {k: v.numpy() for k, v in decoder_params_from_jax(s["decoder"]).items()},
         "content": s["content"], "style": s["style"], "loop": cfg, "adain_loop": adain_cfg}
    return launch(ranks.data_parallel, 2, (a,), spatial=1, deadline_s=DEADLINE,
                  quiet=True, device="cpu")


def _jax_step(params, grad_accum=1):
    opt = jstate.make_optimizer(LR, TOTAL, grad_accum=grad_accum)
    step = jstep.make_train_step(opt, taps=JaxTaps(), precision=JaxPrecision.f32(), lr=LR,
                                 total_steps=TOTAL, grad_accum=grad_accum, donate=False,
                                 dropout=False, norm_method="xla")
    return jstate.create_train_state(jax.tree.map(jnp.asarray, params), opt), step


def _jax_loss_fn(s, params, batch, grams, **kw):
    return jstep.loss_fn(params, jax.tree.map(jnp.asarray, s["vgg"]), jnp.asarray(batch),
                         tuple(jnp.asarray(g) for g in grams), jsched.LossWeightSchedule()(0),
                         None, taps=JaxTaps(), precision=JaxPrecision.f32(),
                         norm_method="xla", **kw)


@functools.lru_cache(maxsize=None)
def _jax(variant: str) -> dict:
    """The JAX package's step on the global batch: metrics, the gradients
    of the first update, params after."""
    s = _setup()
    vgg = jax.tree.map(jnp.asarray, s["vgg"])
    grams = tuple(jnp.asarray(g) for g in s["grams"])
    if variant == "styles":  # the loss with an explicit style_select, then optax
        params = jax.tree.map(jnp.asarray, s["multi"])
        (_, m), grads = jax.jit(jax.value_and_grad(
            lambda p: _jax_loss_fn(s, p, s["batches"][0], s["grams_multi"],
                                   style_select=jnp.asarray(s["select"])),
            has_aux=True))(params)
        opt = jstate.make_optimizer(LR, TOTAL)
        updates, _ = opt.update(grads, opt.init(params), params)
        new = optax.apply_updates(params, updates)
        m = dict(m, grad_norm=optax.global_norm(grads))
        g = _port_params(grads)
        return {"metrics": [jax.tree.map(float, m)], "params": _port_params(new), "grads": g,
                "g_eff": _effective_grads(g, _port_params(s["multi"]))}
    state, step = _jax_step(s["params"], 2 if variant == "accum" else 1)
    if variant == "pad":
        runs = [(s["padded"], jnp.asarray(s["mask"]))]
    else:
        runs = [(b, None) for b in s["batches"][:2 if variant == "accum" else 1]]
    metrics = []
    for b, mask in runs:
        state, m = step(state, vgg, jnp.asarray(b), grams, None, batch_mask=mask)
        metrics.append(jax.tree.map(float, m))
    grad_fn = jax.jit(jax.grad(lambda p, b, mask: _jax_loss_fn(
        s, p, b, s["grams"], batch_mask=mask), has_aux=True))
    grads = [_port_params(grad_fn(jax.tree.map(jnp.asarray, s["params"]), jnp.asarray(b),
                                  mask)[0]) for b, mask in runs]
    mean = {k: sum(g[k] for g in grads) / len(grads) for k in grads[0]}
    return {"metrics": metrics, "params": _port_params(state.params), "step": int(state.step),
            "grads": grads[0], "g_eff": _effective_grads(mean, _port_params(s["params"]))}


def _effective_grads(grads: dict, params: dict) -> dict:
    """|the clipped gradient + 1e-5 * param|: what Adam's first update sees
    (``tests/test_torch_train.py``)."""
    scale = min(1.0, 1.0 / float(np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                                              for g in grads.values()))))
    return {k: np.abs(grads[k] * scale + 1e-5 * params[k]) for k in grads}


def _port_one_process(variant: str) -> dict:
    """The port's one-process step on the same global batch."""
    s = _setup()
    vgg = make_vgg(vgg_params_from_jax(s["vgg"]), "cpu")
    grams = [torch.from_numpy(g) for g in s["grams"]]
    accum = 2 if variant == "accum" else 1
    state = create_train_state(ranks.load_net(_port_params(s["params"]), "cpu"), LR, TOTAL,
                               grad_accum=accum)
    step = make_train_step(lr=LR, total_steps=TOTAL, grad_accum=accum, dropout=False)
    if variant == "pad":
        step(state, vgg, torch.from_numpy(s["padded"]), grams,
             batch_mask=torch.from_numpy(s["mask"]))
    else:
        for b in s["batches"][:accum]:
            step(state, vgg, torch.from_numpy(b), grams)
    return {k: v.detach().numpy() for k, v in state.net.state_dict().items()}


def _close_params(got: dict, want: dict, g_eff: dict) -> None:
    """``tests/test_torch_train.py``'s rule for params after Adam's first
    update, against JAX: all within 2 lr, where the effective gradient is
    at least 1e-4 within 1e-3 lr."""
    for k, w in want.items():
        d = np.abs(got[k] - w)
        assert d.max() <= 2 * LR, k
        firm = g_eff[k] >= 1e-4
        assert d[firm].max(initial=0.0) <= 1e-3 * LR, k


# -- the mesh -------------------------------------------------------------------


def test_rank_layout_matches_jax_mesh():
    """2 x 2 gloo ranks: rank r sits where JAX's make_mesh puts device r
    of a (data, space) = (2, 2) mesh."""
    out = _data_space()
    devs = jax.devices()[:4]
    grid = np.asarray(jax_mesh_plan(devs, spatial=2).mesh.devices)
    for r, o in enumerate(out):
        world, d, sp = o["layout"]
        assert world == r and grid[d, sp] == devs[r], (r, o["layout"])


def test_check_batch_and_place_on_data_axis():
    plan = make_mesh_plan(devices=["cpu", "cpu"])
    jplan = jax_mesh_plan(jax.devices()[:2])
    assert plan.num_data_shards == jplan.num_data_shards == 2
    plan.check_batch(4)
    for p in (plan, jplan):
        with pytest.raises(ValueError, match="not divisible by data-parallel degree 2"):
            p.check_batch(3)
    for b in (4, 3, 1):
        x = np.arange(b * 2 * 2 * 3, dtype=np.float32).reshape(b, 2, 2, 3)
        got = place_on_data_axis(plan.batch_sharding, torch.from_numpy(x))
        want = jax_place(jplan.batch_sharding, jnp.asarray(x))
        shards = sorted({(s.index[0].start or 0, s.data.shape[0])
                         for s in want.addressable_shards})
        assert [c.shape[0] for c in got] == [n for _, n in shards], b
        np.testing.assert_array_equal(torch.cat(got).numpy(), x)
    assert place_on_data_axis(None, torch.zeros(3))[0].shape == (3,)


def test_pipeline_shards_match_jax(tmp_path):
    """Each rank's slice, padded per shard under ``pad_to_multiple``, laid
    end to end is JAX's padded global batch; the masks are its
    ``batch_mask_global``."""
    d = _write_images(str(tmp_path / "imgs"), 12, 4, size=(20, 24))
    want = JaxPipeline(JaxDataset(d, (16, 16), seed=0), 6, seed=0, num_workers=1,
                       pad_to_multiple=8, num_data_shards=2)
    ours = [InputPipeline(ImageFolderDataset(d, (16, 16), seed=0), 6, seed=0,
                          num_workers=1, pad_to_multiple=8, num_data_shards=2,
                          shard_index=i, device="cpu") for i in range(2)]
    assert all(p.local_batch_size == 3 and p.padded_size == 8 for p in ours)
    np.testing.assert_array_equal(np.concatenate([p.batch_mask for p in ours]),
                                  want.batch_mask_global)
    np.testing.assert_array_equal(ours[0].batch_mask_global, want.batch_mask_global)
    got = [list(p.host_batches(num_epochs=1)) for p in ours]
    theirs = list(want.host_batches(num_epochs=1))
    assert len(got[0]) == len(got[1]) == len(theirs) == 2
    for i, b in enumerate(theirs):
        np.testing.assert_array_equal(np.concatenate([got[0][i], got[1][i]]), b)
    with pytest.raises(ValueError, match="not divisible by 4 data shards"):
        InputPipeline(ImageFolderDataset(d, (16, 16)), 6, num_data_shards=4, device="cpu")


# -- the stylizer step ------------------------------------------------------------


@pytest.mark.parametrize("variant", ["plain", "accum", "pad", "styles"])
def test_stylizer_step_matches_jax(dp, variant):
    """Two ranks, each its slice of the global batch (of its mask, of its
    style_select): the global metrics, the summed gradients and the params
    after against the JAX package's step on the whole batch."""
    want = _jax(variant)
    for r in dp:
        got = r[variant]
        for m, w in zip(got["metrics"], want["metrics"]):
            np.testing.assert_allclose(m["loss"], w["loss"], rtol=1e-5)
            for key in ("content_loss", "style_loss", "tv_loss"):
                np.testing.assert_allclose(m[key], w[key], rtol=1e-4, err_msg=key)
            np.testing.assert_allclose(m["grad_norm"], w["grad_norm"], rtol=1e-3)
            assert m["skipped_nonfinite"] == 0
        gmax = max(np.abs(g).max() for g in want["grads"].values())
        for k, g in want["grads"].items():
            np.testing.assert_allclose(got["grads"][k], g, rtol=0, atol=1e-3 * gmax,
                                       err_msg=k)
        _close_params(got["params"], want["params"], want["g_eff"])
        assert got["step"] == (2 if variant == "accum" else 1)


@pytest.mark.parametrize("variant", ["plain", "accum", "pad"])
def test_stylizer_step_matches_one_process(dp, variant):
    """The JAX package's own bound for its data-parallel step: params within
    3e-4 of the one-process step on the same global batch, and bit-equal
    on both ranks."""
    want = _port_one_process(variant)
    for k, w in want.items():
        np.testing.assert_allclose(dp[0][variant]["params"][k], w, rtol=0, atol=3e-4,
                                   err_msg=k)
        np.testing.assert_array_equal(dp[1][variant]["params"][k],
                                      dp[0][variant]["params"][k], err_msg=k)


def test_nonfinite_loss_on_one_rank_skips_on_both(dp):
    """A NaN in rank 1's slice alone: the global loss is non-finite on both
    ranks, neither updates, and their params stay equal to the start."""
    start = _port_params(_setup()["params"])
    for r in dp:
        m = r["nonfinite"]["metrics"][0]
        assert m["skipped_nonfinite"] == 1.0 and not np.isfinite(m["loss"])
        assert r["nonfinite"]["step"] == 0 and r["nonfinite"]["grads"] is None
        for k, v in start.items():
            np.testing.assert_array_equal(r["nonfinite"]["params"][k], v, err_msg=k)


def test_adain_step_matches_jax(dp):
    """Every AdaIN term is a mean: the ranks' gradients are averaged, and the
    step equals the JAX package's on the whole batch."""
    s = _setup()
    opt = optax.adam(LR)
    state = jstate.create_train_state(jax.tree.map(jnp.asarray, s["decoder"]), opt)
    new, m = jadain.make_adain_train_step(opt, donate=False)(
        state, jax.tree.map(jnp.asarray, s["vgg"]), jnp.asarray(s["content"]),
        jnp.asarray(s["style"]))
    want = {k: v.numpy() for k, v in decoder_params_from_jax(_np(new.params)).items()}
    for r in dp:
        got = r["adain"]
        np.testing.assert_allclose(got["metrics"]["loss"], float(m["loss"]), rtol=1e-5)
        np.testing.assert_allclose(got["metrics"]["grad_norm"], float(m["grad_norm"]),
                                   rtol=1e-4)
        assert got["step"] == int(new.step) == 1
        for k, w in want.items():
            np.testing.assert_allclose(got["params"][k], w, rtol=0, atol=2 * LR, err_msg=k)
            np.testing.assert_array_equal(got["params"][k], dp[0]["adain"]["params"][k])


def test_adain_training_loop_two_ranks(dp, loop_dirs):
    """``train_adain(cfg, plan)`` on two data ranks for 2 steps at a global
    batch of 2 (one content and one style image a rank): both return rank
    0's path; rank 0 alone logged and wrote the final decoder."""
    out = loop_dirs[4]
    final = os.path.join(out, "adain_decoder_final.npz")
    assert dp[0]["adain_loop"] == dp[1]["adain_loop"] == final and os.path.exists(final)
    with open(os.path.join(out, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert [r["step"] for r in lines] == [1, 2]
    assert all(np.isfinite(r["loss"]) and r["skipped_nonfinite"] == 0 for r in lines)


def test_training_loop_two_ranks(dp, loop_dirs):
    """``train_style_transfer(cfg, plan)`` on two data ranks for 2 steps:
    both return rank 0's path; rank 0 alone logged the global metrics and
    wrote the one final .npz, which the JAX package reads."""
    out = loop_dirs[2]
    final = os.path.join(out, "style_transfer_final.npz")
    assert dp[0]["loop"] == dp[1]["loop"] == final and os.path.exists(final)
    with open(os.path.join(out, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert [r["step"] for r in lines] == [1, 2]
    assert all(np.isfinite(r["loss"]) and r["skipped_nonfinite"] == 0 for r in lines)
    jparams = JaxStylizer.load_params(final)
    port = load_checkpoint(final)
    np.testing.assert_array_equal(np.asarray(jparams["conv1"]["b"]), port["conv1.conv.bias"])


# -- the 2-D (data x space) step ---------------------------------------------------


@functools.lru_cache(maxsize=None)
def _data_space() -> list:
    s = _setup()
    return launch(ranks.data_space_step, 4,
                  (_port_params(s["params"]),
                   {k: v.numpy() for k, v in vgg_params_from_jax(s["vgg"]).items()},
                   s["batches"][0][:2], s["grams"], LR, TOTAL),
                  spatial=2, deadline_s=DEADLINE, quiet=True, device="cpu")


def test_data_space_step_matches_jax():
    """Four ranks as data 2 x space 2, one sample a data shard, its rows
    split over two ranks, against the JAX package's spatial step on its (2,
    2) host mesh: loss 1e-4 relative, metrics 1e-3, params 2.5e-3, bit-equal
    on every rank."""
    s = _setup()
    opt = jstate.make_optimizer(LR, TOTAL)
    plan = jax_mesh_plan(jax.devices()[:4], spatial=2)
    step = jax_spatial_step(opt, plan, taps=JaxTaps(), lr=LR, total_steps=TOTAL,
                            donate=False)
    st = jstate.create_train_state(jax.tree.map(jnp.asarray, s["params"]), opt)
    new, m = step(st, jax.tree.map(jnp.asarray, s["vgg"]), jnp.asarray(s["batches"][0][:2]),
                  tuple(jnp.asarray(g) for g in s["grams"]), None)
    want = _port_params(new.params)
    out = _data_space()
    for r in out:
        got = r["metrics"][0]
        np.testing.assert_allclose(got["loss"], float(m["loss"]), rtol=1e-4)
        for key in ("content_loss", "style_loss", "tv_loss", "grad_norm"):
            np.testing.assert_allclose(got[key], float(m[key]), rtol=1e-3, err_msg=key)
        assert r["step"] == int(new.step) == 1
        for k, w in want.items():
            np.testing.assert_allclose(r["params"][k], w, rtol=0, atol=2.5e-3, err_msg=k)
            np.testing.assert_array_equal(r["params"][k], out[0]["params"][k], err_msg=k)


# -- serving -------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _trained():
    return JaxStylizer.load_params(str(CHECKPOINT)), load_checkpoint(str(CHECKPOINT))


@pytest.mark.parametrize("precision", ["f32", "int8"])
def test_stylizer_replicas_match_jax_sharded(precision):
    """``Stylizer(sharding=)`` over two CPU replicas against the JAX
    Stylizer with its batch sharding over two devices (the trained
    checkpoint; int8 with dynamic scales, each conv's scale shared over
    the chunks): B=4 and B=2 split, B=3 runs on one device, each bit-equal
    to the one-device Stylizer. Against JAX: f32 within one level; int8
    at ``tests/test_torch_quantized.py``'s size, B=2 (a chunk an image),
    mean |du8| <= 0.5 (at B=4 the port's int8, split or not, is 0.53 from
    JAX's: an int8 code moved by f32 roundoff, not the split)."""
    jparams, params = _trained()
    img = np.random.default_rng(5).integers(0, 256, (4, 40, 56, 3), dtype=np.uint8)
    plan = make_mesh_plan(devices=["cpu", "cpu"])
    ours = Stylizer(params, precision=precision, sharding=plan.batch_sharding)
    theirs = JaxStylizer(jparams, precision=precision,
                         sharding=jax_mesh_plan(jax.devices()[:2]).batch_sharding)
    one = Stylizer(params, precision=precision, device="cpu")
    for b in (4, 3, 2):
        got = ours.stylize_u8(img[:b])
        assert got.shape == img[:b].shape
        np.testing.assert_array_equal(got, one.stylize_u8(img[:b]))
        if precision == "f32" or b == 2:
            d = np.abs(got.astype(int) - theirs.stylize_u8(img[:b]).astype(int))
            assert (d.max() <= 1) if precision == "f32" else (d.mean() <= 0.5), d.max()


def test_int8_replicas_share_the_dynamic_scale(monkeypatch):
    """Each chunk quantizes with the max over both chunks: a chunk run alone
    with those scales as static ones gives the replicas' chunk bit for
    bit, while its own (smaller) max gives other codes."""
    from fast_neural_style_transfer_tpu_torch.infer import quantized as q

    _, params = _trained()
    qp = q.quantize_params(params)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    x[2:] *= 0.25  # the second chunk's activations are smaller
    xs = [torch.from_numpy(x[:2]), torch.from_numpy(x[2:])]
    shared, real = [], q._shared_scales

    def spy(ps, vs):  # a forward visits its convs in _CONV_ORDER
        scales = real(ps, vs)
        shared.append(scales[0])
        return scales

    monkeypatch.setattr(q, "_shared_scales", spy)
    outs = q.apply_int8_replicas([qp, qp], xs)
    monkeypatch.undo()
    assert len(shared) == len(q._CONV_ORDER)
    record = dict(zip(q._CONV_ORDER, shared))
    np.testing.assert_array_equal(torch.cat(outs).numpy(),
                                  q.apply_int8(qp, torch.from_numpy(x)).numpy())
    static = {n: dict(v) for n, v in qp.items() if n != "res_blocks"}
    static["res_blocks"] = [{c: dict(p) for c, p in rb.items()} for rb in qp["res_blocks"]]
    for name, scale in record.items():
        q._get(static, name)["act_scale"] = scale
    np.testing.assert_array_equal(q.apply_int8(static, xs[1]).numpy(), outs[1].numpy())
    assert not np.array_equal(q.apply_int8(qp, xs[1]).numpy(), outs[1].numpy())


def test_arbitrary_stylizer_replicas_match_jax_sharded():
    s = _setup()
    dec = decoder_params_from_jax(s["decoder"])
    vgg = vgg_params_from_jax(s["vgg"])
    style = s["style"][0]
    img = np.random.default_rng(8).integers(0, 256, (4, 32, 40, 3), dtype=np.uint8)
    ours = ArbitraryStylizer(dec, vgg, sharding=make_mesh_plan(
        devices=["cpu", "cpu"]).batch_sharding).set_style_u8(style)
    theirs = JaxArbitrary(jax.tree.map(jnp.asarray, s["decoder"]),
                          jax.tree.map(jnp.asarray, s["vgg"]),
                          sharding=jax_mesh_plan(jax.devices()[:2]).batch_sharding
                          ).set_style_u8(style)
    one = ArbitraryStylizer(dec, vgg, device="cpu").set_style_u8(style)
    for b in (4, 3):
        got = ours.stylize_u8(img[:b], alpha=0.8)
        want = theirs.stylize_u8(img[:b], alpha=0.8)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
        np.testing.assert_array_equal(got, one.stylize_u8(img[:b], alpha=0.8))


def test_stylize_directories_data_parallel(tmp_path, monkeypatch):
    """``stylize_directory(data_parallel=True)`` and the AdaIN bulk job over
    two replicas (the replica plan's devices made two CPUs, as two cards
    would be), 5 images at batch 2 (a short last chunk, wrap-padded): the
    same files as without; a batch that does not divide is refused."""
    from fast_neural_style_transfer_tpu_torch.parallel import mesh

    s = _setup()
    src = _write_images(str(tmp_path / "src"), 5, 9, size=(24, 32))
    ckpt = str(tmp_path / "m.npz")
    from fast_neural_style_transfer_tpu_torch.models import save_params_npz

    save_params_npz(ranks.state_dict(_port_params(s["params"])), ckpt)
    dec = str(tmp_path / "dec.npz")
    save_decoder_npz(decoder_params_from_jax(s["decoder"]), dec)
    style = os.path.join(src, "img_0.png")
    vgg = str(tmp_path / "vgg.npz")
    np.savez(vgg, **{f"{n}.{k}": v for n, p in s["vgg"].items() for k, v in p.items()})
    for name, run in (
            ("flagship", lambda out, **kw: stylize_directory(
                ckpt, src, out, batch_size=2, num_workers=1, **kw)),
            ("adain", lambda out, **kw: stylize_directory_arbitrary(
                dec, src, out, [style], vgg_weights=vgg, batch_size=2, num_workers=1,
                **kw))):
        one = run(str(tmp_path / name / "one"), device="cpu")
        with monkeypatch.context() as m:
            m.setattr(mesh, "_replica_devices", lambda device: (torch.device("cpu"),) * 2)
            two = run(str(tmp_path / name / "two"), data_parallel=True, device="cpu")
        assert len(one) == len(two) == 5 and all(two)
        for a, b in zip(one, two):
            assert open(a, "rb").read() == open(b, "rb").read(), (name, b)
    monkeypatch.setattr(mesh, "_replica_devices", lambda device: (torch.device("cpu"),) * 2)
    with pytest.raises(ValueError, match="not divisible"):
        stylize_directory(ckpt, src, str(tmp_path / "x"), batch_size=3, data_parallel=True,
                          device="cpu")
