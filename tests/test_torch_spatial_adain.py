"""The port's height-sharded AdaIN (``infer/spatial_adain.py``) against the
JAX package's on the CPU (ROADMAP row 15a).

The same seeded decoder and VGG params (``decoder_params_from_jax``,
``vgg_params_from_jax``), content and styles go to JAX's
``stylize_arbitrary_spatial`` on its host mesh and to the port's in 2 and
4 gloo ranks (``tests/torch_spatial_ranks.py``): one style, two blended,
two under per-pixel masks, alpha below 1; heights that split into equal
slabs and heights that do not (the extent path). Tolerance: 1e-4 of the
largest output (f32), as ``tests/test_torch_adain.py``.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_spatial_ranks as ranks
from fast_neural_style_transfer_tpu.infer.spatial_adain import (
    stylize_arbitrary_spatial as jax_spatial_adain,
)
from fast_neural_style_transfer_tpu.models import VGG19Features as JaxVGG
from fast_neural_style_transfer_tpu.parallel import make_mesh_plan as jax_mesh_plan
from fast_neural_style_transfer_tpu_torch.models.vgg_weights import vgg_params_from_jax
from fast_neural_style_transfer_tpu_torch.parallel import launch

# the modules, not the ``adain`` functions their packages export
jadain = importlib.import_module("fast_neural_style_transfer_tpu.models.adain")
tadain = importlib.import_module("fast_neural_style_transfer_tpu_torch.models.adain")
DEADLINE = 90.0


@functools.lru_cache(maxsize=None)
def _params():
    vgg = jax.tree.map(np.asarray, JaxVGG.init(jax.random.PRNGKey(0)))
    dec = jax.tree.map(np.asarray, jadain.AdaINDecoder.init(jax.random.PRNGKey(1)))
    port_vgg = {k: v.numpy() for k, v in vgg_params_from_jax(vgg).items()}
    port_dec = {k: v.numpy() for k, v in tadain.decoder_params_from_jax(dec).items()}
    return vgg, dec, port_vgg, port_dec


def _inputs(h: int, w: int):
    rng = np.random.default_rng(h * 100 + w)
    content = rng.normal(size=(1, h, w, 3)).astype(np.float32)
    styles = [rng.normal(size=(1, 32, 40, 3)).astype(np.float32) for _ in range(2)]
    return content, styles


CASES = [  # (ranks, h, w, kind)
    (2, 64, 48, "single"), (2, 50, 40, "weights"), (4, 52, 40, "masks"),
    (2, 45, 37, "alpha"), (4, 24, 40, "masks"),
]


@pytest.mark.parametrize("n,h,w,kind", CASES,
                         ids=[f"{n}ranks-{h}x{w}-{k}" for n, h, w, k in CASES])
def test_stylize_arbitrary_spatial_matches_jax(n, h, w, kind):
    vgg, dec, port_vgg, port_dec = _params()
    content, styles = _inputs(h, w)
    alpha, weights, masks = 1.0, None, None
    if kind == "single":
        styles = styles[:1]
    elif kind == "weights":
        weights = [0.25, 0.75]
    elif kind == "masks":
        masks = np.zeros((2, h, w), np.float32)
        masks[0, :, : w // 2] = 1.0
        masks[1, :, w // 3:] += 0.5
    else:
        styles, alpha = styles[:1], 0.6
    want = np.asarray(jax_spatial_adain(
        jax.tree.map(jnp.asarray, dec), jax.tree.map(jnp.asarray, vgg),
        jnp.asarray(content), [jnp.asarray(s) for s in styles], jax_mesh_plan(spatial=n),
        alpha=alpha, style_weights=weights, style_masks=masks))
    got = launch(ranks.adain, n, (port_dec, port_vgg, content, styles, alpha, weights,
                                  masks), deadline_s=DEADLINE, quiet=True, device="cpu")
    assert got[0].shape == (1, h, w, 3)
    np.testing.assert_allclose(got[0], want, rtol=0, atol=1e-4 * np.abs(want).max())
    for other in got[1:]:
        np.testing.assert_array_equal(other, got[0])


def test_adain_stylize_cli_spatial(tmp_path):
    """``adain stylize --cpu --spatial 2``: two ranks, rank 0 writes the
    image, which matches the unsharded CLI's (the same pad to a multiple
    of 8) within one level."""
    import torch
    from PIL import Image

    from fast_neural_style_transfer_tpu_torch.cli import adain as adain_cli

    _, _, _, port_dec = _params()
    dec = str(tmp_path / "dec.npz")
    tadain.save_decoder_npz({k: torch.from_numpy(v) for k, v in port_dec.items()}, dec)
    rng = np.random.default_rng(7)
    paths = []
    for name, shape in (("c.png", (44, 37, 3)), ("s.png", (32, 32, 3))):
        paths.append(str(tmp_path / name))
        Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8)).save(paths[-1])
    base = ["stylize", "--cpu", "--decoder", dec, "--content_image", paths[0],
            "--style_image", paths[1], "--alpha", "0.8"]
    adain_cli.main(base + ["--output", str(tmp_path / "s_out.png"), "--spatial", "2"])
    adain_cli.main(base + ["--output", str(tmp_path / "u_out.png")])
    s, u = (np.asarray(Image.open(tmp_path / f), np.int16) for f in ("s_out.png", "u_out.png"))
    assert s.shape == u.shape == (44, 37, 3)
    assert np.abs(s - u).max() <= 1
