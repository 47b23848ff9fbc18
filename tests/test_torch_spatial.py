"""The port's height-sharded ops and inference against the JAX package's on
the CPU (ROADMAP row 15a).

The port's side runs in gloo ranks spawned by ``parallel.launch`` (2 and 4
ranks, both halo transports; ``tests/torch_spatial_ranks.py``, which never
imports JAX); the JAX side on the 8-device host mesh of
``tests/conftest.py`` under ``shard_map``. The same seeded numpy inputs go
to both. Tolerances are JAX's own: 1e-4 on features and outputs.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from PIL import Image

import torch_spatial_ranks as ranks
from fast_neural_style_transfer_tpu.core.shapes import pad_to_multiple_reflect
from fast_neural_style_transfer_tpu.infer.spatial import stylize_spatial as jax_stylize_spatial
from fast_neural_style_transfer_tpu.models import TransformerNet as JaxNet
from fast_neural_style_transfer_tpu.ops import sharded as jsh
from fast_neural_style_transfer_tpu.parallel import make_mesh_plan as jax_mesh_plan
from fast_neural_style_transfer_tpu.parallel.mesh import shard_map_checked
from fast_neural_style_transfer_tpu_torch.cli import begin_inference
from fast_neural_style_transfer_tpu_torch.models import params_from_jax
from fast_neural_style_transfer_tpu_torch.models.weights import save_params_npz
from fast_neural_style_transfer_tpu_torch.ops import sharded as sh
from fast_neural_style_transfer_tpu_torch.parallel import launch
from fast_neural_style_transfer_tpu_torch.parallel.mesh import choose_backend

# every multi-process call ends within this many seconds, or fails
DEADLINE = 90.0
B, W, C, CO = 2, 12, 4, 6
ROWS = P(None, "space", None, None)
CONFIGS = [(2, "auto"), (2, "mailbox"), (4, "auto")]


def _inputs(n: int) -> dict:
    rng = np.random.default_rng(10 + n)
    h = 8 * n
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return {"x": f(B, h, W, C), "y": f(B, h, W, C), "w9": f(9, 9, C, CO) * 0.1,
            "b9": f(CO), "w3": f(3, 3, C, CO) * 0.3, "b3": f(CO),
            "wt": f(3, 3, C, CO) * 0.3, "bt": f(CO), "gamma": f(C) + 1.0,
            "beta": f(C), "gamma_n": f(B, C) + 1.0, "beta_n": f(B, C),
            "extent": h - 5}


def _shmap(fn, n, in_specs, out_specs):
    mesh = jax_mesh_plan(spatial=n).mesh
    return jax.jit(shard_map_checked(fn, mesh, in_specs=in_specs, out_specs=out_specs,
                                     check=False))


def _jax_ops(n: int, a: dict) -> dict:
    """The JAX package's ``ops/sharded.py`` on the same inputs."""
    x, y = jnp.asarray(a["x"]), jnp.asarray(a["y"])
    e = a["extent"]
    rows = lambda fn, *args: _shmap(fn, n, (ROWS,) + (P(),) * len(args), ROWS)(x, *args)  # noqa: E731
    out = {
        "from_prev": rows(lambda v: jsh.from_prev(v[:, -2:])),
        "from_next": rows(lambda v: jsh.from_next(v[:, :2])),
        "halo_reflect": rows(lambda v: jsh.halo_extend(v, 4, mode="reflect")),
        "halo_zero": rows(lambda v: jsh.halo_extend(v, 1, mode="zero")),
        "global_row_index": _shmap(lambda v: jsh.global_row_index(v.shape[1]), n,
                                   (ROWS,), P("space"))(x),
        "mask_rows_from": rows(lambda v: jsh.mask_rows_from(v, e)),
        "fetch_global_row": _shmap(lambda v: jsh.fetch_global_row(v, e - 2), n,
                                   (ROWS,), P())(x),
        "set_global_row": rows(lambda v: jsh.set_global_row(
            v, e, jnp.full((B, 1, W, C), 7.0, v.dtype))),
        "pin_reflect_rows": rows(lambda v: jsh.pin_reflect_rows(v, e, 4)),
        "reflect_conv_k9": rows(lambda v, w, b: jsh.reflect_conv2d_sharded(v, w, b),
                                jnp.asarray(a["w9"]), jnp.asarray(a["b9"])),
        "reflect_conv_k3s2": rows(lambda v, w, b: jsh.reflect_conv2d_sharded(
            v, w, b, stride=2), jnp.asarray(a["w3"]), jnp.asarray(a["b3"])),
        "conv_same": rows(lambda v, w, b: jsh.conv2d_same_sharded(v, w, b),
                          jnp.asarray(a["w3"]), jnp.asarray(a["b3"])),
        "max_pool": rows(jsh.max_pool2d_sharded),
        "conv_transpose": rows(lambda v, w, b: jsh.conv_transpose2d_sharded(v, w, b),
                               jnp.asarray(a["wt"]), jnp.asarray(a["bt"])),
        "in_relu": rows(lambda v, g, b: jsh.instance_norm_sharded(v, g, b, relu=True),
                        jnp.asarray(a["gamma"]), jnp.asarray(a["beta"])),
        "in_sample_affine": rows(lambda v, g, b: jsh.instance_norm_sharded(v, g, b),
                                 jnp.asarray(a["gamma_n"])[:, None, None, :],
                                 jnp.asarray(a["beta_n"])[:, None, None, :]),
        "in_masked": rows(lambda v, g, b, ext: jsh.instance_norm_sharded(
            v, g, b, relu=True, extent=ext), jnp.asarray(a["gamma"]),
            jnp.asarray(a["beta"]), jnp.asarray(e, jnp.int32)),
        "gram": _shmap(jsh.gram_matrix_sharded, n, (ROWS,), P())(x),
        "content_loss": _shmap(jsh.content_loss_sharded, n, (ROWS, ROWS), P())(x, y),
        "tv_loss": _shmap(jsh.total_variation_loss_sharded, n, (ROWS,), P())(x),
    }
    return {k: np.asarray(v) for k, v in out.items()}


@functools.lru_cache(maxsize=None)
def _port_ops(n: int, transport: str) -> dict:
    return launch(ranks.ops, n, (_inputs(n),), transport=transport,
                  deadline_s=DEADLINE, quiet=True, device="cpu")[0]


@functools.lru_cache(maxsize=None)
def _jax_ops_cached(n: int) -> dict:
    return _jax_ops(n, _inputs(n))


OPS = ["from_prev", "from_next", "halo_reflect", "halo_zero", "global_row_index",
       "mask_rows_from", "fetch_global_row", "set_global_row", "pin_reflect_rows",
       "reflect_conv_k9", "reflect_conv_k3s2", "conv_same", "max_pool", "conv_transpose",
       "in_relu", "in_sample_affine", "in_masked", "gram", "content_loss", "tv_loss"]


@pytest.mark.parametrize("config", CONFIGS, ids=[f"{n}ranks-{t}" for n, t in CONFIGS])
@pytest.mark.parametrize("name", OPS)
def test_sharded_op_matches_jax(name, config):
    """Each ``ops/sharded.py`` function (the IN one plain, with per-sample
    affines, and masked by an extent) on 2 and 4 gloo ranks, both halo
    transports, against JAX's under shard_map."""
    n, transport = config
    got, want = _port_ops(n, transport)[name], _jax_ops_cached(n)[name]
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=1e-4, atol=1e-4 * max(1.0, np.abs(want).max()),
                               err_msg=name)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_op_gradients_match_unsharded(n):
    """Gradients through the halo exchange, the transpose conv's halo and
    the sharded IN (its two backward passes around the ranks' sums) equal
    the port's unsharded ops' on the whole image: a lost halo gradient, or
    an IN that all-reduced dgamma / dbeta too, would not."""
    errs = launch(ranks.ops_grads, n, (_inputs(n),), deadline_s=DEADLINE, quiet=True, device="cpu")[0]
    assert errs and max(errs.values()) <= 1e-5, errs


def _jax_params():
    return jax.tree.map(np.asarray, JaxNet.init(jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _port_params() -> dict:
    return {k: v.numpy() for k, v in params_from_jax(_jax_params()).items()}


@pytest.mark.parametrize("n,h,w", [(2, 64, 48), (4, 52, 40), (4, 49, 40), (4, 16, 40)],
                         ids=["aligned", "unaligned-52", "unaligned-49", "tiny"])
def test_stylize_spatial_matches_jax(n, h, w):
    """``stylize_spatial`` against the JAX package's at an aligned height, at
    heights that do not split into equal slabs of whole multiples of 4 (the
    extent path: pins, masked moments, the zeroed transpose row) and at a
    height too small for the k9 halo (padded to 8 rows a rank)."""
    x = np.random.default_rng(h).normal(size=(1, h, w, 3)).astype(np.float32)
    want = np.asarray(jax_stylize_spatial(jax.tree.map(jnp.asarray, _jax_params()),
                                          jnp.asarray(x), jax_mesh_plan(spatial=n)))
    got = launch(ranks.stylize, n, (_port_params(), x), deadline_s=DEADLINE,
                 quiet=True, device="cpu")
    assert got[0].shape == (1, h, w, 3)
    np.testing.assert_allclose(got[0], want, rtol=1e-3, atol=1e-4)
    for other in got[1:]:  # every rank gathers the whole output
        np.testing.assert_array_equal(other, got[0])


def test_stylize_spatial_matches_single_device_route():
    """The sharded route equals the port's own pad-4 / run / crop forward."""
    from fast_neural_style_transfer_tpu_torch.core.shapes import (
        pad_to_multiple_reflect as pad4,
    )

    x = np.random.default_rng(5).normal(size=(2, 50, 36, 3)).astype(np.float32)
    got = launch(ranks.stylize, 2, (_port_params(), x), transport="mailbox",
                 deadline_s=DEADLINE, quiet=True, device="cpu")[0]
    net = ranks.load_net(_port_params(), "cpu").eval()
    with torch.no_grad():
        canon, _ = pad4(torch.from_numpy(x), 4)
        want = net(canon)[:, :50, :36].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    canon_j, _ = pad_to_multiple_reflect(jnp.asarray(x), 4)
    assert canon_j.shape[1] == canon.shape[1]


class _Axis:
    """A stand-in 'space' axis for the checks that raise before any
    exchange."""

    index, size = 0, 4


def test_sharded_halo_rejects_too_small_slab():
    """A local slab shorter than the halo raises a clear error (JAX's
    ``tests/test_parallel.py`` case)."""
    w = torch.zeros(8, 3, 9, 9)
    x = torch.zeros(1, 3, 4, 16).contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="halo"):
        sh.reflect_conv2d_sharded(x, w, None, stride=1, axis=_Axis())


def test_sharded_strided_conv_rejects_unaligned_local_height():
    w = torch.zeros(8, 3, 3, 3)
    x = torch.zeros(1, 3, 5, 16).contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="stride"):
        sh.reflect_conv2d_sharded(x, w, None, stride=2, axis=_Axis())


def test_backward_of_masked_instance_norm_refuses():
    """No training path masks rows; the sharded IN's backward refuses an
    extent rather than give a gradient the JAX formula does not."""
    out = launch(_masked_backward, 2, deadline_s=DEADLINE, quiet=True, device="cpu")
    assert all("takes no extent" in o for o in out), out


def _masked_backward(plan):
    x = torch.randn(1, 2, 4, 4).contiguous(memory_format=torch.channels_last)
    x.requires_grad_(True)
    y = sh.instance_norm_sharded(x, torch.ones(2), torch.zeros(2), axis=plan.space,
                                 extent=6)
    try:
        y.sum().backward()
    except NotImplementedError as e:
        return str(e)
    return "no error"


def _fails(plan):
    if plan.space.index == 1:
        raise ValueError("rank one fails on purpose")
    torch.distributed.barrier()  # rank 0 would wait here for the failed rank
    return "unreachable"


def _sleeps(plan):
    import time
    time.sleep(60)


def test_launch_ends_every_rank_when_one_fails():
    """A failed rank's traceback comes back, and the rank waiting for it in
    a collective is ended rather than left to hang."""
    with pytest.raises(RuntimeError, match="rank one fails on purpose"):
        launch(_fails, 2, deadline_s=DEADLINE, quiet=True, device="cpu")


def test_launch_deadline():
    with pytest.raises(TimeoutError):
        launch(_sleeps, 2, deadline_s=3.0, quiet=True, device="cpu")


def test_backend_rule():
    assert choose_backend("cpu", 2)[0] == "gloo"
    if torch.cuda.device_count() < 2:
        assert choose_backend("cuda", 2)[0] == "gloo"


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_launch_runs_on_the_card_unless_asked_for_the_cpu():
    """``launch`` and ``make_mesh_plan`` take None as the card, as every
    entry point of the port does: without one they raise, never quietly
    falling back to CPU ranks."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch(_sleeps, 2, deadline_s=DEADLINE, quiet=True)
    out = launch(_default_plan_device, 2, deadline_s=DEADLINE, quiet=True, device="cpu")
    assert all("no CUDA device" in o for o in out), out


def _default_plan_device(plan):
    from fast_neural_style_transfer_tpu_torch.parallel import make_mesh_plan

    try:
        make_mesh_plan(2)
    except RuntimeError as e:
        return str(e)
    return "no error"


def test_make_mesh_plan_refuses_a_data_axis():
    """Two ranks as a 2 x 1 (data, space) mesh: a data axis of two, the
    rank's data index its rank; a spatial degree that does not divide the
    ranks is refused."""
    out = launch(_data_axis, 2, deadline_s=DEADLINE, quiet=True, device="cpu")
    assert [o[0] for o in out] == [(2, 0, 1), (2, 1, 1)], out
    assert all("not divisible by spatial=3" in o[1] for o in out), out


def _data_axis(plan):
    from fast_neural_style_transfer_tpu_torch.parallel import make_mesh_plan

    dp = make_mesh_plan(1, device="cpu")
    try:
        make_mesh_plan(3, device="cpu")
    except ValueError as e:
        return (dp.data.size, dp.data.index, dp.space.size), str(e)
    return (dp.data.size, dp.data.index, dp.space.size), "no error"


def test_begin_inference_cli_spatial(tmp_path):
    """``begin_inference --spatial 2`` on the CPU: two ranks, rank 0 writes
    the image, which matches the single-device route of ``stylize_spatial``
    (pad to a multiple of 4, run, crop) written the same way, within one
    level."""
    from fast_neural_style_transfer_tpu_torch.core.shapes import (
        pad_to_multiple_reflect as pad4,
    )
    from fast_neural_style_transfer_tpu_torch.utils import load_image, save_image

    ckpt = str(tmp_path / "m.npz")
    save_params_npz({k: torch.from_numpy(v) for k, v in _port_params().items()}, ckpt)
    img = np.random.default_rng(3).integers(0, 256, (44, 30, 3), dtype=np.uint8)
    src = str(tmp_path / "in.png")
    Image.fromarray(img).save(src)
    begin_inference.main(["--model_path", ckpt, "--content_image", src, "--output_dir",
                          str(tmp_path / "o"), "--device", "cpu", "--spatial", "2",
                          "--output_name", "s.png"])
    assert sorted(p.name for p in (tmp_path / "o").iterdir()) == ["s.png"]
    net = ranks.load_net(_port_params(), "cpu").eval()
    with torch.no_grad():
        canon, _ = pad4(torch.from_numpy(load_image(src)), 4)
        save_image(net(canon)[:, :44, :30].numpy(), str(tmp_path / "u.png"))
    s = np.asarray(Image.open(tmp_path / "o" / "s.png"), np.int16)
    u = np.asarray(Image.open(tmp_path / "u.png"), np.int16)
    assert s.shape == u.shape == (44, 30, 3)
    assert np.abs(s - u).max() <= 1
