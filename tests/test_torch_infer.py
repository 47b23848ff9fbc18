"""The port's inference path against the JAX package's on the CPU.

Both Stylizers run f32 on the same random weights (JAX ``init``, carried
over by ``params_from_jax``). The uint8 outputs may differ by one level
where a value lands within float error of a rounding boundary, so the bound
is max |du8| <= 1.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from fast_neural_style_transfer_tpu.export.torch_convert import (
    save_torch_checkpoint,
    to_torch_state_dict,
)
from fast_neural_style_transfer_tpu.infer import stylize as jstylize
from fast_neural_style_transfer_tpu.models.transformer import TransformerNet as JaxNet
from fast_neural_style_transfer_tpu.train.checkpoint import save_params_npz
from fast_neural_style_transfer_tpu_torch.cli import begin_inference
from fast_neural_style_transfer_tpu_torch.infer import (
    Stylizer,
    stylize_directory,
    stylize_image_file,
)
from fast_neural_style_transfer_tpu_torch.models import (
    TransformerNet,
    load_checkpoint,
    params_from_jax,
)
from fast_neural_style_transfer_tpu_torch.models import save_params_npz as port_save_params_npz


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs with several xdist workers
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jax_params():
    return JaxNet.init(jax.random.PRNGKey(7))


@pytest.fixture(scope="module")
def state_dict(jax_params):
    return params_from_jax(jax.tree.map(np.asarray, jax_params))


@pytest.fixture(scope="module")
def ckpt_pth(jax_params, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ckpt") / "m.pth")
    save_torch_checkpoint(jax_params, path)
    return path


def _img(h, w, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


@pytest.mark.parametrize("preserve_color", ["off", "luma"])
def test_stylize_u8_matches_jax(jax_params, state_dict, preserve_color):
    img = _img(40, 52)
    want = jstylize.Stylizer(jax_params, preserve_color=preserve_color).stylize_u8(img)
    got = Stylizer(state_dict, device="cpu",
                   preserve_color=preserve_color).stylize_u8(img)
    assert got.shape == want.shape == (40, 52, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_network_space_call_and_stylize_match_jax(jax_params, state_dict):
    x = np.random.default_rng(1).standard_normal((2, 20, 28, 3)).astype(np.float32)
    j = jstylize.Stylizer(jax_params, bucket_multiple=32)
    t = Stylizer(state_dict, device="cpu", bucket_multiple=32)
    np.testing.assert_allclose(t(x), j(x), rtol=0, atol=2e-4)
    np.testing.assert_allclose(t.stylize(x[0]), j.stylize(x[0]), rtol=0, atol=1e-4)


def test_raw_forward_u8_checks_alignment(state_dict):
    sty = Stylizer(state_dict, device="cpu", bucket_multiple=32)
    out = sty.raw_forward_u8(torch.zeros((1, 32, 64, 3), dtype=torch.uint8))
    assert out.shape == (1, 32, 64, 3) and out.dtype == torch.uint8
    with pytest.raises(ValueError, match="bucket-aligned"):
        sty.raw_forward_u8(torch.zeros((1, 30, 64, 3), dtype=torch.uint8))
    with pytest.raises(TypeError):
        sty.stylize_u8(np.zeros((8, 8, 3), np.float32))


def test_pth_and_npz_load_like_jax_savers(jax_params, state_dict, ckpt_pth, tmp_path):
    npz = str(tmp_path / "m.npz")
    save_params_npz(jax_params, npz)
    for path in (ckpt_pth, npz):
        sd = load_checkpoint(path)
        assert set(sd) == set(state_dict)
        for k in sd:
            torch.testing.assert_close(sd[k], state_dict[k], rtol=0, atol=0)
    bare = str(tmp_path / "bare.pth")
    torch.save(state_dict, bare)
    assert set(load_checkpoint(bare)) == set(state_dict)


@pytest.fixture(scope="module")
def multi_params():
    """A 2-style JAX tree whose IN banks' rows differ."""
    tree = jax.tree.map(np.asarray, JaxNet.init(jax.random.PRNGKey(8), num_styles=2))
    rng = np.random.default_rng(9)
    for node in [tree[k] for k in ("norm1", "norm2", "norm3", "norm4")] + [
            b[k] for b in tree["res_blocks"] for k in ("in1", "in2")]:
        node["gamma"] = (1 + 0.5 * rng.standard_normal(node["gamma"].shape)).astype(np.float32)
        node["beta"] = (0.3 * rng.standard_normal(node["beta"].shape)).astype(np.float32)
    return tree


def test_multi_style_checkpoints_load_both_ways(multi_params, tmp_path):
    """A multi-style .npz from the JAX package's save_params_npz and a
    .pth of its to_torch_state_dict (its save_torch_checkpoint takes
    single-style params only) load with their (S, C) banks; the port's
    save_params_npz writes an .npz that JAX's Stylizer.load_params reads
    back bit for bit."""
    want = params_from_jax(multi_params)
    npz, pth = str(tmp_path / "m.npz"), str(tmp_path / "m.pth")
    save_params_npz(multi_params, npz)
    torch.save({"model_state_dict": {k: torch.from_numpy(np.array(v)) for k, v in
                                     to_torch_state_dict(multi_params).items()}}, pth)
    for path in (npz, pth):
        sd = load_checkpoint(path)
        assert set(sd) == set(want) and sd["norm1.weight"].shape == (2, 64)
        for k in sd:
            torch.testing.assert_close(sd[k], want[k], rtol=0, atol=0)
    ours = str(tmp_path / "ours.npz")
    port_save_params_npz(want, ours)
    back = jax.tree.map(np.asarray, jstylize.Stylizer.load_params(ours))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(multi_params)):
        assert a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("style", [1, [0.25, 0.75]], ids=["index", "blend"])
def test_from_checkpoint_bakes_a_style_like_jax(multi_params, style, tmp_path):
    npz = str(tmp_path / "m.npz")
    save_params_npz(multi_params, npz)
    img = _img(36, 44, seed=4)
    want = jstylize.Stylizer.from_checkpoint(npz, style=style).stylize_u8(img)
    got = Stylizer.from_checkpoint(npz, style=style, device="cpu").stylize_u8(img)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    with pytest.raises(ValueError, match="2-style checkpoint"):
        Stylizer.from_checkpoint(npz, device="cpu")
    with pytest.raises(ValueError, match="bake_style"):
        Stylizer(load_checkpoint(npz), device="cpu")


def test_unported_checkpoints_raise(tmp_path):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        load_checkpoint(str(tmp_path))  # an Orbax-style directory
    with pytest.raises(ValueError, match="TorchScript"):
        load_checkpoint(str(tmp_path / "m.pt"))
    # int8 is ported: quantized once, at construction
    assert Stylizer(TransformerNet().state_dict(), device="cpu",
                    precision="int8").qparams["final_conv"]["wmat"].shape == (8, 2592)


def test_stylize_image_file_matches_jax(jax_params, ckpt_pth, tmp_path):
    src = str(tmp_path / "in.png")
    Image.fromarray(_img(36, 44, seed=2)).save(src)
    ours = stylize_image_file(ckpt_pth, src, str(tmp_path / "ours.png"),
                              device="cpu")
    theirs = jstylize.stylize_image_file(ckpt_pth, src, str(tmp_path / "jax.png"))
    a = np.asarray(Image.open(ours), np.int32)
    b = np.asarray(Image.open(theirs), np.int32)
    assert a.shape == (36, 44, 3)
    assert np.abs(a - b).max() <= 1


def test_stylize_directory_mixed_shapes(ckpt_pth, tmp_path):
    src = tmp_path / "content"
    (src / "sub").mkdir(parents=True)
    shapes = {"a.png": (20, 24), "b.jpg": (20, 24), "sub/c.png": (33, 17),
              "d.png": (20, 24)}
    for i, (name, (h, w)) in enumerate(shapes.items()):
        Image.fromarray(_img(h, w, seed=10 + i)).save(src / name)
    written = stylize_directory(ckpt_pth, str(src), str(tmp_path / "ours"),
                                batch_size=2, num_workers=2, device="cpu")
    theirs = jstylize.stylize_directory(ckpt_pth, str(src), str(tmp_path / "jax"),
                                        batch_size=2, num_workers=2)
    expect = {os.path.splitext(n)[0] + "_stylized.jpg": hw
              for n, hw in shapes.items()}
    assert [os.path.relpath(p, tmp_path / "ours") for p in written] == \
        [os.path.relpath(p, tmp_path / "jax") for p in theirs]
    for ours, jax_path in zip(written, theirs):
        a = np.asarray(Image.open(ours), np.int32)
        b = np.asarray(Image.open(jax_path), np.int32)
        assert a.shape == (*expect[os.path.relpath(ours, tmp_path / "ours")], 3)
        # the same JPEG encoder on u8 arrays that differ by <= 1 level
        assert np.abs(a - b).mean() < 1


def test_stylize_directory_one_worker_finishes(ckpt_pth, tmp_path):
    """With num_workers=1 the pipeline's prep task must not wait on a task
    queued to its own pool. Run in a subprocess with a timeout, so that a
    hang fails the test instead of the worker (pool threads are joined at
    exit)."""
    src = tmp_path / "content"
    src.mkdir()
    for i in range(3):
        Image.fromarray(_img(20, 24, seed=30 + i)).save(src / f"{i}.png")
    script = (
        "import sys, torch\n"
        "torch.set_num_threads(1)\n"
        "from fast_neural_style_transfer_tpu_torch.infer import stylize_directory\n"
        "out = stylize_directory(sys.argv[1], sys.argv[2], sys.argv[3], batch_size=2,\n"
        "                        num_workers=1, device='cpu')\n"
        "print(sum(p is not None for p in out))\n")
    proc = subprocess.run(
        [sys.executable, "-c", script, ckpt_pth, str(src), str(tmp_path / "out")],
        capture_output=True, text=True, timeout=60,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == "3"
    assert sorted(os.listdir(tmp_path / "out")) == [
        f"{i}_stylized.jpg" for i in range(3)]


def test_begin_inference_cli(ckpt_pth, tmp_path, capsys):
    src = str(tmp_path / "in.png")
    Image.fromarray(_img(24, 28, seed=3)).save(src)
    begin_inference.main(["--model_path", ckpt_pth, "--content_image", src,
                          "--output_dir", str(tmp_path / "o"), "--device", "cpu",
                          "--output_name", "x.png"])
    assert "saved" in capsys.readouterr().out
    assert Image.open(tmp_path / "o" / "x.png").size == (28, 24)
    begin_inference.main(["--model_path", ckpt_pth, "--content_image", src,
                          "--output_dir", str(tmp_path / "o"), "--device", "cpu",
                          "--output_name", "q.png", "--precision", "int8"])
    assert Image.open(tmp_path / "o" / "q.png").size == (28, 24)
    # --data_parallel splits --content_dir batches over the replicas (one on
    # the CPU here; two in tests/test_torch_data_parallel.py): the same files
    (tmp_path / "c").mkdir()
    Image.fromarray(_img(24, 28, seed=3)).save(tmp_path / "c" / "in.png")
    for flags in ([], ["--data_parallel"]):
        begin_inference.main(["--model_path", ckpt_pth, "--content_dir", str(tmp_path / "c"),
                              "--output_dir", str(tmp_path / "d" / str(len(flags))),
                              "--device", "cpu", "--batch_size", "2", *flags])
    assert np.array_equal(np.asarray(Image.open(tmp_path / "d" / "1" / "in_stylized.jpg")),
                          np.asarray(Image.open(tmp_path / "d" / "0" / "in_stylized.jpg")))
    # --spatial runs (tests/test_torch_spatial.py) but keeps the JAX CLI's
    # two refusals
    for flags, match in ((["--content_dir", str(tmp_path)], "cannot be combined"),
                         (["--content_image", src, "--precision", "int8"], "int8")):
        with pytest.raises(SystemExit, match=match):
            begin_inference.main(["--model_path", ckpt_pth, "--device", "cpu",
                                  "--output_dir", str(tmp_path / "o"), "--spatial", "2",
                                  *flags])
    # a style flag on a single-style checkpoint raises JAX's error
    with pytest.raises(ValueError, match="single-style checkpoint"):
        begin_inference.main(["--model_path", ckpt_pth, "--content_image", src,
                              "--output_dir", str(tmp_path / "o"), "--device", "cpu",
                              "--style_index", "0"])
