"""The port's video path (frozen IN statistics) against the JAX package's on
the CPU, and the plain versions of the IN forward kernel's capture and
inject modes.

Same inputs on both sides: frames and activations from a numpy seed, the
JAX package's seeded stylizer params carried across (``params_from_jax``).
Tolerances, each stated where it is used:
- stylizer outputs: 1e-4 of the largest (f32, 14 IN sites and 16 convs
  summed in other orders);
- captured moments: means 1e-5 of the largest, variances 1e-5 relative;
- u8 frames: max |delta| <= 1 (one rounding step of *255 + 0.5);
- the port's own contracts on the CPU (capture, self-injection, blend 0):
  bit for bit, since capture and inject share the plain forward's
  arithmetic (``ops/cuda_norm.py``); on the card ``chip_smoke.py`` and the
  ``gpu`` tests hold the kernels to the same.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from fast_neural_style_transfer_tpu.cli import video as jcli
from fast_neural_style_transfer_tpu.infer import video as jvideo
from fast_neural_style_transfer_tpu.models import TransformerNet as JaxNet
from fast_neural_style_transfer_tpu.models.transformer import bake_style as jax_bake
from fast_neural_style_transfer_tpu.train.checkpoint import save_params_npz as jax_save_npz
from fast_neural_style_transfer_tpu_torch.cli import video as tcli
from fast_neural_style_transfer_tpu_torch.infer import video as tvideo
from fast_neural_style_transfer_tpu_torch.models import TransformerNet, params_from_jax
from fast_neural_style_transfer_tpu_torch.ops import cuda_norm
from fast_neural_style_transfer_tpu_torch.ops.norm import (
    apply_instance_norm_stats,
    instance_norm_stats,
)


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)  # the suite runs with several xdist workers
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jparams():
    return jax.tree.map(np.asarray, JaxNet.init(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def net(jparams):
    n = TransformerNet()
    n.load_state_dict(params_from_jax(jparams), strict=True)
    return n.eval().to(memory_format=torch.channels_last)


def _x(seed, n=2, hw=32):
    return np.random.default_rng(seed).normal(size=(n, hw, hw, 3)).astype(np.float32)


def _close(got, want, frac):
    """|got - want| <= frac * max|want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=frac * np.abs(want).max())


def _panning_clip(n=6, h=48, w=56, seed=0):
    """A seeded texture panned 3 px right and 2 px down a frame."""
    rng = np.random.default_rng(seed)
    big = rng.integers(30, 220, (h + 2 * n + 8, w + 3 * n + 8, 3)).astype(np.int32)
    big = ((big + np.roll(big, 1, 0) + np.roll(big, 1, 1)) // 3).astype(np.uint8)
    return np.stack([big[2 * i:2 * i + h, 3 * i:3 * i + w] for i in range(n)])


# -- the model: capture and inject ---------------------------------------------


def test_return_stats_matches_jax(jparams, net):
    """Outputs (1e-4 of the largest) and all 14 (mean, var) pairs (means
    1e-5 of the largest, variances 1e-5 relative), B=2, 32x32."""
    x = _x(1)
    want, wstats = JaxNet.apply(jax.tree.map(jnp.asarray, jparams), jnp.asarray(x),
                                return_stats=True)
    with torch.no_grad():
        got, stats = net(torch.from_numpy(x), return_stats=True)
    _close(got.numpy(), want, 1e-4)
    assert len(stats) == len(wstats) == 14
    for (m, v), (jm, jv) in zip(stats, wstats):
        jm, jv = np.asarray(jm)[:, 0, 0], np.asarray(jv)[:, 0, 0]
        assert m.shape == v.shape == (2, jm.shape[1], 1, 1) and m.dtype == torch.float32
        _close(m.numpy()[:, :, 0, 0], jm, 1e-5)
        np.testing.assert_allclose(v.numpy()[:, :, 0, 0], jv, rtol=1e-5)


@pytest.mark.parametrize("blend", [0.0, 0.5, 1.0])
def test_injection_matches_jax(jparams, net, blend):
    """A B=2 batch normalized with a B=1 reference frame's statistics at
    stats_blend 0, 0.5, 1: 1e-4 of the largest output."""
    x, ref = _x(2), _x(3, n=1)
    jp = jax.tree.map(jnp.asarray, jparams)
    _, jstats = JaxNet.apply(jp, jnp.asarray(ref), return_stats=True)
    want = JaxNet.apply(jp, jnp.asarray(x), in_stats=jstats, stats_blend=blend)
    with torch.no_grad():
        _, stats = net(torch.from_numpy(ref), return_stats=True)
        got = net(torch.from_numpy(x), in_stats=stats, stats_blend=blend)
    _close(got.numpy(), want, 1e-4)


def test_capture_matches_plain_forward(net):
    """Capture changes nothing: the same bits as the plain forward."""
    x = torch.from_numpy(_x(4, n=1))
    with torch.no_grad():
        y0 = net(x)
        y1, stats = net(x, return_stats=True)
    assert torch.equal(y0, y1)
    assert len(stats) == 14 and stats[0][0].shape == (1, 64, 1, 1)


def test_self_injection_is_identity(net):
    """Injecting a forward's own statistics (blend 1) gives its bits."""
    x = torch.from_numpy(_x(5))
    with torch.no_grad():
        y0 = net(x)
        _, stats = net(x, return_stats=True)
        y2 = net(x, in_stats=stats)
        y3, again = net(x, in_stats=stats, return_stats=True)
    assert torch.equal(y0, y2) and torch.equal(y0, y3)
    assert all(torch.equal(a, b) for p, q in zip(stats, again) for a, b in zip(p, q))


def test_blend_zero_matches_per_frame(net):
    """stats_blend 0 is the per-frame forward, bit for bit; blend 1 with
    another frame's statistics is not."""
    x, ref = torch.from_numpy(_x(6)), torch.from_numpy(_x(7, n=1))
    with torch.no_grad():
        _, stats = net(ref, return_stats=True)
        y_plain = net(x)
        y_b0 = net(x, in_stats=stats, stats_blend=0.0)
        y_b1 = net(x, in_stats=stats, stats_blend=1.0)
    assert torch.equal(y_plain, y_b0)
    assert float((y_b1 - y_plain).abs().max()) > 1e-3


def test_stats_refusals(net):
    x = torch.from_numpy(_x(8, n=1))
    with torch.no_grad():
        _, stats = net(x, return_stats=True)
        with pytest.raises(ValueError, match="14 IN sites"):
            net(x, in_stats=stats[:3])
        with pytest.raises(ValueError, match="onepass"):
            net(x, norm_method="onepass", return_stats=True)
        with pytest.raises(ValueError, match="stats_blend"):
            net(x, in_stats=stats, stats_blend=1.5)
        with pytest.raises(ValueError, match="norm_method"):
            net(x, norm_method="pallas")
    with pytest.raises(RuntimeError, match="inference only"):
        net(x, return_stats=True)


# -- the kernel wrappers' plain versions -----------------------------------------


def _site(seed, n=3, c=16, hw=8):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.normal(size=(n, c, hw, hw)) * 2 + 0.5).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=c).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=c).astype(np.float32))
    return x.contiguous(memory_format=torch.channels_last), g, b, rng


@pytest.mark.parametrize("onepass", [False, True])
def test_capture_plain_version(onepass):
    """On a CPU tensor capture is the plain version: the forward's y, mean
    and inv unchanged, var its moments (exactly), inv = rsqrt(var + eps);
    no launch is counted."""
    x, g, b, _ = _site(0)
    before = dict(cuda_norm.instance_norm_fwd.launches_by_mode)
    y0, m0, i0 = cuda_norm.instance_norm_fwd(x, g, b, relu=True, onepass=onepass)
    y, m, i, v = cuda_norm.instance_norm_fwd(x, g, b, relu=True, onepass=onepass,
                                             capture=True)
    assert all(torch.equal(p, q) for p, q in ((y0, y), (m0, m), (i0, i)))
    _, v_want = cuda_norm._moments(x.float(), onepass)
    assert torch.equal(v, v_want) and torch.equal(i, torch.rsqrt(v + 1e-5))
    assert cuda_norm.instance_norm_fwd.launches_by_mode == before


@pytest.mark.parametrize("rows", ["one", "per_sample"])
@pytest.mark.parametrize("affine", ["channel", "sample"])
@pytest.mark.parametrize("blend", [0.0, 0.5, 1.0])
def test_inject_plain_version(rows, affine, blend):
    """Inject with a (1, C) or (N, C) reference and a (C,) or (N, C)
    affine: blend 1 takes the reference alone (no own moments returned),
    0 the sample's own (the plain forward's bits), and between them
    blend * ref + (1 - blend) * own against the formula written out (f32,
    1e-6 of the largest)."""
    x, g, b, rng = _site(1)
    n, c = x.shape[:2]
    if affine == "sample":
        g = torch.from_numpy(rng.normal(size=(n, c)).astype(np.float32))
        b = torch.from_numpy(rng.normal(size=(n, c)).astype(np.float32))
    r = 1 if rows == "one" else n
    rm = torch.from_numpy(rng.normal(size=(r, c)).astype(np.float32))
    rv = torch.from_numpy(rng.random((r, c)).astype(np.float32) + 0.5)
    y, mean, var = cuda_norm.instance_norm_apply_stats(x, g, b, rm, rv, blend=blend,
                                                       relu=True)
    own_m, own_v = cuda_norm._moments(x.float(), False)
    if blend == 1.0:
        assert mean is None and var is None
    else:
        assert torch.equal(mean, own_m) and torch.equal(var, own_v)
    m = blend * rm + (1 - blend) * own_m
    v = blend * rv + (1 - blend) * own_v
    gg = g.reshape(-1, c)[:, :, None, None]
    bb = b.reshape(-1, c)[:, :, None, None]
    want = torch.relu((x - m[:, :, None, None]) * torch.rsqrt(v + 1e-5)[:, :, None, None]
                      * gg + bb)
    _close(y.numpy(), want.numpy(), 1e-6)
    if blend == 0.0:
        assert torch.equal(y, cuda_norm.instance_norm_fwd(x, g, b, relu=True)[0])


def test_inject_refusals():
    x, g, b, _ = _site(2)
    with pytest.raises(ValueError, match="neither"):
        cuda_norm.instance_norm_apply_stats(x, g, b, torch.zeros(2, 16), torch.ones(2, 16))
    with pytest.raises(ValueError, match="blend"):
        cuda_norm.instance_norm_apply_stats(x, g, b, torch.zeros(1, 16), torch.ones(1, 16),
                                            blend=-0.1)
    assert set(cuda_norm.instance_norm_fwd.launches_by_mode) == {
        "plain", "capture", "inject", "stats", "sharded_apply"}


def test_norm_stats_functions_match_jax():
    """ops/norm.py's instance_norm_stats / apply_instance_norm_stats (on the
    CPU: the moments by the JAX package's formula, the apply through the
    inject mode's plain version) against JAX's: 1e-6 of the largest."""
    from fast_neural_style_transfer_tpu.ops import norm as jnorm

    x, g, b, _ = _site(3)
    xj = jnp.asarray(x.permute(0, 2, 3, 1).numpy())
    for method in ("stable", "onepass"):
        m, v = instance_norm_stats(x, method)
        jm, jv = jnorm.instance_norm_stats(xj, method)
        _close(m.numpy()[:, :, 0, 0], np.asarray(jm)[:, 0, 0], 1e-6)
        _close(v.numpy()[:, :, 0, 0], np.asarray(jv)[:, 0, 0], 1e-6)
    m, v = instance_norm_stats(x[:1])
    y = apply_instance_norm_stats(x, m, v, g, b, relu=True)
    jm, jv = jnorm.instance_norm_stats(xj[:1])
    want = jnorm.apply_instance_norm_stats(xj, jm, jv, jnp.asarray(g.numpy()),
                                           jnp.asarray(b.numpy()), relu=True)
    _close(y.permute(0, 2, 3, 1).numpy(), want, 1e-6)


# -- VideoStylizer -----------------------------------------------------------------


@pytest.mark.parametrize("blend", [1.0, 0.5])
def test_video_stylizer_matches_jax(jparams, blend):
    """A seeded 6-frame panning clip (48x56, padded to the 64 bucket) in
    batches of 4 (a repeated-frame tail): max |delta u8| <= 1 (f32)."""
    clip = _panning_clip()
    got = tvideo.VideoStylizer(params_from_jax(jparams), device="cpu",
                               stats_blend=blend).stylize_frames(clip, batch_size=4)
    want = jvideo.VideoStylizer(jax.tree.map(jnp.asarray, jparams),
                                stats_blend=blend).stylize_frames(clip, batch_size=4)
    assert got.shape == clip.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_video_stylizer_contracts(jparams):
    """Frame 0 is the reference, so stabilized and plain agree on it (u8
    rounding only); a short tail equals a whole batch; reset drops the
    reference; raw_forward needs one and a bucket-aligned batch."""
    clip = _panning_clip(n=5, h=32, w=32, seed=1)
    sd = params_from_jax(jparams)
    stable = tvideo.VideoStylizer(sd, device="cpu")
    a = stable.stylize_frames(clip, batch_size=4)
    plain = tvideo.VideoStylizer(sd, device="cpu", stabilize=False).stylize_frames(clip)
    assert np.abs(a[0].astype(int) - plain[0].astype(int)).max() <= 1
    np.testing.assert_array_equal(a, stable.stylize_frames(clip, batch_size=5))
    assert stable._stats is not None
    stable.reset_reference()
    assert stable._stats is None
    with pytest.raises(RuntimeError, match="set_reference"):
        stable.raw_forward(torch.zeros((1, 64, 64, 3), dtype=torch.uint8))
    stable.set_reference(clip[0])
    with pytest.raises(ValueError, match="bucket-aligned"):
        stable.raw_forward(torch.zeros((1, 32, 48, 3), dtype=torch.uint8))
    assert stable.raw_forward(torch.zeros((2, 64, 64, 3), dtype=torch.uint8)).shape == (
        2, 64, 64, 3)


def test_video_stylizer_rejects_bad_inputs(jparams):
    vs = tvideo.VideoStylizer(params_from_jax(jparams), device="cpu")
    with pytest.raises(ValueError, match=r"\(N, H, W, 3\)"):
        vs.stylize_frames(np.zeros((64, 64, 3), np.uint8))
    with pytest.raises(TypeError, match="uint8"):
        vs.stylize_frames(np.zeros((2, 64, 64, 3), np.float32))
    with pytest.raises(ValueError, match="stats_blend"):
        tvideo.VideoStylizer(params_from_jax(jparams), device="cpu", stats_blend=1.5)


def test_from_checkpoint_bakes_multi_style(tmp_path):
    """A 2-style .npz needs style= (baked like the JAX package's); a
    single-style one refuses it."""
    multi = jax.tree.map(np.asarray, JaxNet.init(jax.random.PRNGKey(3), num_styles=2))
    rng = np.random.default_rng(0)
    multi = jax.tree.map(lambda a: a + rng.normal(size=a.shape).astype(np.float32) * 0.3
                         if a.ndim == 2 else a, multi)
    path = str(tmp_path / "multi.npz")
    jax_save_npz(multi, path)
    with pytest.raises(ValueError, match="multi-style"):
        tvideo.VideoStylizer.from_checkpoint(path, device="cpu")
    vs = tvideo.VideoStylizer.from_checkpoint(path, style=1, device="cpu")
    want = params_from_jax(jax.tree.map(np.asarray, jax_bake(multi, 1)))
    got = vs.net.state_dict()
    assert all(torch.allclose(got[k], want[k], rtol=1e-6, atol=1e-7) for k in want)
    single = str(tmp_path / "single.pth")
    torch.save(TransformerNet().state_dict(), single)
    with pytest.raises(ValueError, match="single-style"):
        tvideo.VideoStylizer.from_checkpoint(single, style=0, device="cpu")


def test_flicker_score_matches_jax():
    clip = _panning_clip(n=4, h=16, w=16)
    mask = np.zeros((16, 16), bool)
    mask[4:12, 2:9] = True
    assert tvideo.flicker_score(clip) == pytest.approx(jvideo.flicker_score(clip), rel=1e-7)
    assert tvideo.flicker_score(clip, mask=mask) == pytest.approx(
        jvideo.flicker_score(clip, mask=mask), rel=1e-7)
    assert tvideo.flicker_score(clip[:1]) == 0.0
    with pytest.raises(ValueError, match="mask shape"):
        tvideo.flicker_score(clip, mask=np.ones((4, 4), bool))


# -- clip IO -------------------------------------------------------------------------


def test_gif_roundtrip(tmp_path):
    """GIF is paletted: count, shape and dtype survive, values roughly."""
    clip = _panning_clip(n=4, h=24, w=32)
    gif = str(tmp_path / "sub" / "clip.gif")
    tvideo.write_frames(clip, gif, fps=10)
    back = tvideo.read_frames(gif)
    assert back.shape == clip.shape and back.dtype == np.uint8
    assert np.abs(back.astype(int) - clip.astype(int)).mean() < 12
    np.testing.assert_array_equal(back, jvideo.read_frames(gif))
    assert tvideo.read_frames(gif, max_frames=2, size=(12, 16)).shape == (2, 12, 16, 3)


def test_frame_dir_roundtrip_and_natural_sort(tmp_path):
    """PNG frames come back exactly; unpadded numbering sorts naturally
    (frame_2 before frame_10)."""
    clip = _panning_clip(n=3, h=8, w=8)
    tvideo.write_frames(clip, str(tmp_path / "frames"))
    np.testing.assert_array_equal(tvideo.read_frames(str(tmp_path / "frames")), clip)
    d = tmp_path / "natural"
    d.mkdir()
    for i in (10, 2, 1):
        Image.fromarray(np.full((4, 4, 3), i, np.uint8)).save(d / f"frame_{i}.png")
    assert [int(f[0, 0, 0]) for f in tvideo.read_frames(str(d))] == [1, 2, 10]
    assert tvideo._natural_key("frame_10.png") == jvideo._natural_key("frame_10.png")


def test_read_frames_bad_inputs(tmp_path):
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no frames"):
        tvideo.read_frames(str(tmp_path / "empty"))
    d = tmp_path / "mixed"
    d.mkdir()
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(d / "a.png")
    Image.fromarray(np.zeros((4, 6, 3), np.uint8)).save(d / "b.png")
    with pytest.raises(ValueError, match="disagree on shape"):
        tvideo.read_frames(str(d))
    assert tvideo.read_frames(str(d), size=(4, 4)).shape == (2, 4, 4, 3)


# -- the CLI ------------------------------------------------------------------------


def test_cli_flags_match_jax():
    """Every flag of the JAX package's fnst-video, plus --device/--cpu."""
    opts = lambda p: {o for a in p._actions for o in a.option_strings}
    got, want = opts(tcli.build_parser()), opts(jcli.build_parser())
    assert want <= got and got - want == {"--device", "--cpu"}
    args = tcli.build_parser().parse_args(["--model_path", "m", "--content", "c",
                                           "--output", "o"])
    assert args.device == "cuda" and args.stats_blend == 1.0 and args.batch_size == 8


def test_cli_stylizes_a_gif_on_cpu(jparams, tmp_path, capsys):
    """The CLI on the CPU: a seeded GIF in, a GIF out, the JSON summary
    printed; the output equals VideoStylizer's on the same frames."""
    model = str(tmp_path / "m.npz")
    jax_save_npz(jparams, model)
    clip = _panning_clip(n=3, h=32, w=40)
    src = str(tmp_path / "in.gif")
    tvideo.write_frames(clip, src)
    out = str(tmp_path / "out.gif")
    summary = tcli.main(["--model_path", model, "--content", src, "--output", out,
                         "--cpu", "--batch_size", "2", "--stats_blend", "0.7"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == summary and summary["frames"] == 3 and summary["device"] == "cpu"
    assert os.path.exists(out)
    frames = tvideo.read_frames(src)
    want = tvideo.VideoStylizer.from_checkpoint(
        model, device="cpu", stats_blend=0.7).stylize_frames(frames, batch_size=2)
    assert summary["output_flicker"] == pytest.approx(tvideo.flicker_score(want))
