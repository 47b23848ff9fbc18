"""Package rules of the PyTorch port, and its kernel on the card.

- No file of the port, and not ``chip_smoke.py``, imports JAX, its
  libraries or the JAX package (an AST scan, exact top-level names: the
  port's own name starts with the JAX package's).
- Entry points run on the card unless asked for the CPU: with no card they
  raise instead of carrying on quietly.
- The ``gpu``-marked tests hold each kernel against its plain version on
  the card; they decide inside the test whether a card exists.
"""

import ast
import pathlib
import types

import numpy as np
import pytest
import torch

import fast_neural_style_transfer_tpu_torch as port
from fast_neural_style_transfer_tpu_torch.core.shapes import resolve_device
from fast_neural_style_transfer_tpu_torch.infer import Stylizer
from fast_neural_style_transfer_tpu_torch.models import TransformerNet
from fast_neural_style_transfer_tpu_torch.ops import cuda_conv, cuda_conv_rgb, cuda_norm, cuda_pad

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_DIR = pathlib.Path(port.__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "optax", "orbax", "fast_neural_style_transfer_tpu"}


def _imported_top_names(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _port_files():
    return sorted(PORT_DIR.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    bad = sorted(set(_imported_top_names(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_compares_exact_top_level_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import fast_neural_style_transfer_tpu_torch.ops\n"
                 "from fast_neural_style_transfer_tpu.ops import conv\n"
                 "import jax.numpy as jnp\n")
    names = set(_imported_top_names(f))
    assert names & FORBIDDEN == {"fast_neural_style_transfer_tpu", "jax"}


def test_no_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Stylizer(TransformerNet().state_dict())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Stylizer(TransformerNet().state_dict(), device="cuda")
    assert resolve_device("cpu").type == "cpu"


def test_wrapper_refuses_other_devices():
    x = torch.zeros((1, 8, 4, 4), device="meta")
    g = torch.ones(8, device="meta")
    m = torch.zeros((1, 8), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        cuda_norm.instance_norm_fwd(x, g, g)
    with pytest.raises(ValueError, match="cuda or cpu"):
        cuda_norm.instance_norm_bwd(x, x, m, m, g, g)
    w = torch.zeros((8, 3, 3, 3), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        cuda_conv.conv2d_same_dx(x, w)
    with pytest.raises(ValueError, match="cuda or cpu"):
        cuda_conv.conv2d_same_bwd(x, torch.zeros((1, 3, 4, 4), device="meta"), w)


def test_package_data_ships_kernel_sources():
    text = (ROOT / "pyproject.toml").read_text()
    assert "fast_neural_style_transfer_tpu_torch*" in text
    assert 'fast_neural_style_transfer_tpu_torch = ["csrc/*.cu", "native/*.cpp"]' in text
    for src in ("csrc/instance_norm.cu", "csrc/conv_same_bwd.cu", "native/fnst_host.cpp"):
        assert (PORT_DIR / src).is_file()


# the port's counterparts of the JAX package's last modules and of the
# repo's tools and examples that run it
_TOOLING = ["utils/visualization.py", "native/__init__.py", "cli/parity.py",
            "tools/soak.py", "tools/adain_soak.py", "examples/quickstart.py",
            "examples/multistyle.py", "examples/serving.py", "examples/adain.py"]


@pytest.mark.parametrize("rel", _TOOLING)
def test_tooling_modules_are_scanned(rel):
    path = PORT_DIR / rel
    assert path in _port_files()
    assert not set(_imported_top_names(path)) & FORBIDDEN
    tree = ast.parse(path.read_text())
    # nothing reaches outside its checkout through a fixed absolute path
    # (the kernel's /proc interface aside)
    consts = [n.value for n in ast.walk(tree)
              if isinstance(n, ast.Constant) and isinstance(n.value, str)]
    assert not [c for c in consts if c.startswith("/") and "/" in c[1:]
                and not c.startswith("/proc/")], rel


# (N, H, W, C, relu): the IN sites of a 256^2 forward at B=1, two of them
# at the training batch of 20 (all on the one-launch kernel), and a slab
# larger than the card holds at once (the two-launch kernel)
_SITES = [(1, 128, 128, 64, True), (1, 64, 64, 256, True),
          (1, 64, 64, 256, False), (1, 256, 256, 32, True),
          (20, 256, 256, 32, True), (20, 64, 64, 256, False),
          (1, 1024, 1024, 32, True)]


def _site_inputs(rng, n, h, w, c, dtype):
    x = torch.from_numpy(
        (rng.standard_normal((n, c, h, w)) * 2 + 0.5).astype(np.float32))
    x = x.to("cuda", dtype).contiguous(memory_format=torch.channels_last)
    g = torch.from_numpy(rng.standard_normal(c).astype(np.float32)).cuda()
    b = torch.from_numpy(rng.standard_normal(c).astype(np.float32)).cuda()
    return x, g, b


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("onepass", [False, True])
def test_kernel_matches_plain_on_card(dtype, onepass):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(0)
    for n, h, w, c, relu in _SITES:
        x, g, b = _site_inputs(rng, n, h, w, c, dt)
        route = cuda_norm.fwd_plan(x, onepass=onepass).route
        assert route == ("two_launch" if h == 1024 else "one_launch")
        with torch.inference_mode():
            y, mean, inv = cuda_norm.instance_norm_fwd(x, g, b, relu=relu,
                                                       onepass=onepass)
            torch.cuda.synchronize()
            y_r, mean_r, inv_r = cuda_norm.instance_norm_fwd_reference(
                x.float(), g, b, relu=relu, onepass=onepass)
        # f32: sums in another order; bf16: one rounding of the output
        tol = dict(rtol=1e-4, atol=1e-4) if dtype == "float32" else \
            dict(rtol=1 / 128, atol=1e-2)
        torch.testing.assert_close(y.float(), y_r, **tol)
        torch.testing.assert_close(mean, mean_r, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(inv, inv_r, rtol=1e-3 if onepass else 1e-4,
                                   atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("onepass", [False, True])
def test_kernel_repeats_bit_for_bit_on_card(dtype, onepass):
    """Both forward kernels merge in a fixed order: two calls give the same
    bits of y, mean and inv."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rng = np.random.default_rng(3)
    for n, h, w, c, relu in (_SITES[4], _SITES[6]):
        x, g, b = _site_inputs(rng, n, h, w, c, getattr(torch, dtype))
        with torch.inference_mode():
            first = cuda_norm.instance_norm_fwd(x, g, b, relu=relu, onepass=onepass)
            second = cuda_norm.instance_norm_fwd(x, g, b, relu=relu, onepass=onepass)
        for a, b2 in zip(first, second):
            ints = torch.int16 if a.element_size() == 2 else torch.int32
            assert torch.equal(a.view(ints), b2.view(ints))


# (N, H, W, C): the IN sites of a training step at B=2
_BWD_SITES = [(2, 128, 128, 64), (2, 64, 64, 256), (2, 256, 256, 32)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("relu", [False, True])
def test_in_bwd_kernel_matches_plain_on_card(dtype, relu):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(1)
    for n, h, w, c in _BWD_SITES:
        x, g, mean, inv, gamma, beta = _bwd_inputs(rng, n, h, w, c, dt)
        with torch.inference_mode():
            dx, dgn, dbn = cuda_norm.instance_norm_bwd(x, g, mean, inv, gamma, beta,
                                                       relu=relu)
            torch.cuda.synchronize()
            dx_r, dgn_r, dbn_r = cuda_norm.instance_norm_bwd_reference(
                x.float(), g.float(), mean, inv, gamma, beta, relu=relu)
        # f32: reductions in another order; bf16: one rounding of dx
        tol = dict(rtol=1e-4, atol=1e-4) if dtype == "float32" else \
            dict(rtol=1 / 128, atol=1e-2)
        torch.testing.assert_close(dx.float(), dx_r, **tol)
        scale = float(dgn_r.abs().max()) + float(dbn_r.abs().max())
        torch.testing.assert_close(dgn, dgn_r, rtol=1e-4, atol=1e-4 * scale)
        torch.testing.assert_close(dbn, dbn_r, rtol=1e-4, atol=1e-4 * scale)


def _bwd_inputs(rng, n, h, w, c, dt):
    mk = lambda s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).cuda()
    x = (mk((n, c, h, w)) * 2 + 0.5).to(dt).contiguous(memory_format=torch.channels_last)
    g = mk((n, c, h, w)).to(dt).contiguous(memory_format=torch.channels_last)
    gamma, beta = mk(c), mk(c)
    with torch.inference_mode():
        _, mean, inv = cuda_norm.instance_norm_fwd(x, gamma, beta)
    return x, g, mean, inv, gamma, beta


# (N, H, W, C, route): the largest IN site of a training step at its batch
# of 20, and a slab larger than the card holds at once
_BWD_ROUTES = [(20, 256, 256, 32, "one_launch"), (2, 1024, 1024, 32, "two_launch")]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", _BWD_ROUTES, ids=lambda c: c[-1])
def test_in_bwd_kernel_routes_and_matches_plain_on_card(dtype, case):
    """The backward on the route plan_bwd picks (asserted) against its
    plain version, the ReLU on: the same tolerances as above."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    n, h, w, c, route = case
    dt = getattr(torch, dtype)
    x, g, mean, inv, gamma, beta = _bwd_inputs(np.random.default_rng(4), n, h, w, c, dt)
    assert cuda_norm.bwd_plan(x, g).route == route
    before = dict(cuda_norm.instance_norm_bwd.launches_by_route)
    with torch.inference_mode():
        dx, dgn, dbn = cuda_norm.instance_norm_bwd(x, g, mean, inv, gamma, beta, relu=True)
        torch.cuda.synchronize()
        dx_r, dgn_r, dbn_r = cuda_norm.instance_norm_bwd_reference(
            x.float(), g.float(), mean, inv, gamma, beta, relu=True)
    assert cuda_norm.instance_norm_bwd.launches_by_route[route] == before[route] + 1
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == "float32" else \
        dict(rtol=1 / 128, atol=1e-2)
    torch.testing.assert_close(dx.float(), dx_r, **tol)
    scale = float(dgn_r.abs().max()) + float(dbn_r.abs().max())
    torch.testing.assert_close(dgn, dgn_r, rtol=1e-4, atol=1e-4 * scale)
    torch.testing.assert_close(dbn, dbn_r, rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", _BWD_ROUTES, ids=lambda c: c[-1])
def test_in_bwd_kernel_repeats_bit_for_bit_on_card(dtype, case):
    """Both backward kernels sum in a fixed order: two calls give the same
    bits of dx, dgamma and dbeta."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    n, h, w, c, _ = case
    x, g, mean, inv, gamma, beta = _bwd_inputs(
        np.random.default_rng(5), n, h, w, c, getattr(torch, dtype))
    with torch.inference_mode():
        first = cuda_norm.instance_norm_bwd(x, g, mean, inv, gamma, beta, relu=True)
        second = cuda_norm.instance_norm_bwd(x, g, mean, inv, gamma, beta, relu=True)
    for a, b in zip(first, second):
        ints = torch.int16 if a.element_size() == 2 else torch.int32
        assert torch.equal(a.view(ints), b.view(ints))


# (N, H, W, C_in, k, route of dx-only): VGG conv1_1 at B=2 (256^2 and a
# ragged 200x300) and at the training batch of 20, and a k=9, C_in=1 conv
# (k*k*C_in = 81) that the tap-packed kernel does not take
_CONV_CASES = [(2, 256, 256, 3, 3, "tap_packed"), (2, 200, 300, 3, 3, "tap_packed"),
               (20, 256, 256, 3, 3, "tap_packed"), (2, 64, 96, 1, 9, "tiled")]


def _conv_inputs(rng, n, h, w, ci, k, dt):
    mk = lambda s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).cuda()
    g = mk((n, 64, h, w)).to(dt).contiguous(memory_format=torch.channels_last)
    x = mk((n, ci, h, w)).to(dt).contiguous(memory_format=torch.channels_last)
    return g, x, (mk((64, ci, k, k)) * 0.1).to(dt)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", _CONV_CASES, ids=lambda c: "x".join(map(str, c)))
def test_conv_bwd_kernel_matches_plain_on_card(dtype, case):
    """dx-only on the route plan_conv_dx picks (asserted, and counted by
    route), and full mode (the tiled kernel), against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    n, h, w, ci, k, route = case
    dt = getattr(torch, dtype)
    g, x, wt = _conv_inputs(np.random.default_rng(2), n, h, w, ci, k, dt)
    assert cuda_conv.conv_dx_plan(g, wt).route == route
    before = dict(cuda_conv.conv2d_same_dx.launches_by_route)
    with torch.inference_mode():
        dx_only = cuda_conv.conv2d_same_dx(g, wt)
        dx, dw, db = cuda_conv.conv2d_same_bwd(g, x, wt)
        torch.cuda.synchronize()
        dx_r, dw_r, db_r = cuda_conv.conv2d_same_bwd_reference(g.float(), x.float(),
                                                               wt.float())
    assert cuda_conv.conv2d_same_dx.launches_by_route[route] == before[route] + 1
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == "float32" else \
        dict(rtol=1 / 128, atol=2e-2)
    torch.testing.assert_close(dx_only.float(), dx_r, **tol)
    torch.testing.assert_close(dx.float(), dx_r, **tol)
    # dw, db: sums over N*H*W products in another order
    torch.testing.assert_close(dw, dw_r, rtol=1e-4, atol=1e-4 * float(dw_r.abs().max()))
    torch.testing.assert_close(db, db_r, rtol=1e-4, atol=1e-4 * float(db_r.abs().max()))
    with pytest.raises(ValueError, match="gate"):
        cuda_conv.conv2d_same_dx(g, torch.zeros((64, 16, 3, 3), dtype=dt, device="cuda"))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [_CONV_CASES[2], _CONV_CASES[3]], ids=lambda c: c[-1])
def test_conv_dx_repeats_bit_for_bit_on_card(dtype, case):
    """Neither dx kernel uses atomics, and every sum has a fixed order: two
    calls give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    n, h, w, ci, k, _ = case
    g, _, wt = _conv_inputs(np.random.default_rng(6), n, h, w, ci, k, getattr(torch, dtype))
    with torch.inference_mode():
        first = cuda_conv.conv2d_same_dx(g, wt)
        second = cuda_conv.conv2d_same_dx(g, wt)
    ints = torch.int16 if first.element_size() == 2 else torch.int32
    assert torch.equal(first.view(ints), second.view(ints))


# (N, H, W, C, route): per-sample (N, C) affines (multi-style training) on
# both routes of each direction: a 64^2 x 256 training site at B=8 on the
# one-launch kernels, and a slab larger than the card holds at once on the
# two-launch kernels
_AFFINE_CASES = [(8, 64, 64, 256, "one_launch"), (2, 1024, 1024, 32, "two_launch")]


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", _AFFINE_CASES, ids=lambda c: c[-1])
def test_per_sample_affine_kernels_match_plain_on_card(dtype, case):
    """Forward and backward with (N, C) gamma / beta whose rows differ
    (negative entries included, so the ReLU gate flips per sample) against
    the plain versions, on the route asserted, counted as "sample"
    launches; an (N, C) affine of equal rows gives the (C,) call's bits.
    Tolerances as the tests above."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    n, h, w, c, route = case
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(7)
    x, g, _, _, gamma, beta = _bwd_inputs(rng, n, h, w, c, dt)
    rows = lambda: torch.from_numpy(rng.standard_normal((n, c)).astype(np.float32)).cuda()
    g_rows, b_rows = rows(), rows()
    one = route == "one_launch"
    fplan = cuda_norm.fwd_plan(x, one_launch=one)
    bplan = cuda_norm.bwd_plan(x, g, one_launch=one)
    assert fplan.route == bplan.route == route
    cuda_norm._check(x, g_rows, b_rows)
    fwd_before = cuda_norm.instance_norm_fwd.launches_by_affine["sample"]
    bwd_before = cuda_norm.instance_norm_bwd.launches_by_affine["sample"]
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == "float32" else dict(rtol=1 / 128, atol=1e-2)
    with torch.inference_mode():
        y, mean, inv = cuda_norm._launch_fwd(x, g_rows, b_rows, fplan, eps=1e-5, relu=True,
                                             onepass=False)
        dx, dgn, dbn = cuda_norm._launch_bwd(x, g, mean, inv, g_rows, b_rows, bplan, relu=True)
        torch.cuda.synchronize()
        y_r, mean_r, inv_r = cuda_norm.instance_norm_fwd_reference(x.float(), g_rows, b_rows,
                                                                   relu=True)
        dx_r, dgn_r, dbn_r = cuda_norm.instance_norm_bwd_reference(
            x.float(), g.float(), mean, inv, g_rows, b_rows, relu=True)
        assert cuda_norm.instance_norm_fwd.launches_by_affine["sample"] == fwd_before + 1
        assert cuda_norm.instance_norm_bwd.launches_by_affine["sample"] == bwd_before + 1
        torch.testing.assert_close(y.float(), y_r, **tol)
        torch.testing.assert_close(inv, inv_r, rtol=1e-4, atol=0)
        torch.testing.assert_close(dx.float(), dx_r, **tol)
        scale = float(dgn_r.abs().max()) + float(dbn_r.abs().max())
        torch.testing.assert_close(dgn, dgn_r, rtol=1e-4, atol=1e-4 * scale)
        torch.testing.assert_close(dbn, dbn_r, rtol=1e-4, atol=1e-4 * scale)
        same_g, same_b = gamma.expand(n, c).contiguous(), beta.expand(n, c).contiguous()
        outs = {}
        for kind, (ga, be) in (("rows", (same_g, same_b)), ("channel", (gamma, beta))):
            fwd = cuda_norm._launch_fwd(x, ga, be, fplan, eps=1e-5, relu=True, onepass=False)
            bwd = cuda_norm._launch_bwd(x, g, mean, inv, ga, be, bplan, relu=True)
            outs[kind] = fwd + bwd
        assert all(torch.equal(_bits(a), _bits(b))
                   for a, b in zip(outs["rows"], outs["channel"]))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ref_rows", ["one", "per_sample"])
def test_capture_inject_kernels_on_card(dtype, ref_rows):
    """The IN forward's capture and inject modes at the 256^2 sites (B=1,
    one launch) and the large slab (two launches): capture returns the
    plain call's y, mean, inv bits and var against the plain version (1e-4
    relative); inject at blend 1 with the captured moments gives the plain
    forward's y bit for bit (the inject kernel, one launch); at blend 0.5
    against a (1, C) or (N, C) reference it matches the plain inject within
    the forward's tolerances. Counted by mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(11)
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == "float32" else dict(rtol=1 / 128, atol=1e-2)
    for n, h, w, c, relu in _SITES[:4] + _SITES[-1:]:
        n = max(n, 2)
        x, g, b = _site_inputs(rng, n, h, w, c, dt)
        refs = 1 if ref_rows == "one" else n
        ref_m = torch.from_numpy(rng.standard_normal((refs, c)).astype(np.float32)).cuda()
        ref_v = torch.from_numpy(rng.random((refs, c)).astype(np.float32) + 0.5).cuda()
        before = dict(cuda_norm.instance_norm_fwd.launches_by_mode)
        with torch.inference_mode():
            y0, m0, i0 = cuda_norm.instance_norm_fwd(x, g, b, relu=relu)
            y1, m1, i1, v1 = cuda_norm.instance_norm_fwd(x, g, b, relu=relu, capture=True)
            y2, _, _ = cuda_norm.instance_norm_apply_stats(x, g, b, m1, v1, relu=relu)
            yb, mb, vb = cuda_norm.instance_norm_apply_stats(x, g, b, ref_m, ref_v,
                                                             blend=0.5, relu=relu)
            torch.cuda.synchronize()
            _, _, _, v_r = cuda_norm.instance_norm_fwd_reference(
                x.float(), g, b, relu=relu, capture=True)
            yb_r, mb_r, vb_r = cuda_norm.instance_norm_apply_stats_reference(
                x.float(), g, b, ref_m, ref_v, blend=0.5, relu=relu)
        assert all(torch.equal(_bits(p), _bits(q)) for p, q in
                   ((y0, y1), (m0, m1), (i0, i1), (y0, y2)))
        torch.testing.assert_close(v1, v_r, rtol=1e-4, atol=1e-6)
        torch.testing.assert_close(yb.float(), yb_r, **tol)
        torch.testing.assert_close(mb, mb_r, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(vb, vb_r, rtol=1e-4, atol=1e-6)
        after = cuda_norm.instance_norm_fwd.launches_by_mode
        assert [after[k] - before[k] for k in ("plain", "capture", "inject")] == [1, 1, 2]


_CHECKPOINT = ROOT / "evidence" / "soak40k_r5" / "style_transfer_final.pth"


@pytest.mark.gpu
def test_true_division_on_card():
    """u8_to_network and the int8 scales divide on the card as on the CPU,
    bit for bit (a Python-number divisor would make CUDA multiply by its
    float reciprocal: one ulp off for 126 of the 256 u8 values)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from fast_neural_style_transfer_tpu_torch.infer import quantized as q
    from fast_neural_style_transfer_tpu_torch.utils.image_io import u8_to_network

    u8 = torch.arange(256, dtype=torch.uint8).view(1, 16, 16, 1).expand(2, 16, 16, 3)
    assert torch.equal(u8_to_network(u8.cuda()).cpu(), u8_to_network(u8))
    m = torch.from_numpy(np.random.default_rng(0).uniform(1e-3, 100.0, 4096).astype(np.float32))
    assert torch.equal(q._div127(m.cuda()).cpu(), q._div127(m))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 8, 16, 16), np.float32))
    codes, s = q._quantize_act(x)
    codes_card, s_card = q._quantize_act(x.cuda())
    assert torch.equal(s_card.cpu(), s) and torch.equal(codes_card.cpu(), codes)


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 8])
def test_int8_forward_on_card(batch):
    """The int8 Stylizer on the card against its CPU path on the trained
    checkpoint. The int8 products are exact on both and the rest of the
    path is the same IEEE operations, but for the IN kernel, whose f32
    roundings differ from its plain version's and can flip an activation
    code: fed the card's IN outputs, the CPU path runs each of the 15 convs
    on the card's input, so the x it hands each of the 14 IN sites and its
    output are the card's bit for bit; free running, SSIM >= 0.98. The IN
    forward kernel launches at the 14 sites of the forward."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from unittest import mock

    from fast_neural_style_transfer_tpu_torch.infer import quantized as q
    from fast_neural_style_transfer_tpu_torch.utils.ssim import ssim

    img = np.random.default_rng(batch).integers(0, 256, (batch, 128, 128, 3), np.uint8)
    cpu = Stylizer.from_checkpoint(str(_CHECKPOINT), precision="int8", device="cpu")
    sty = Stylizer.from_checkpoint(str(_CHECKPOINT), precision="int8", device="cuda")
    card_x, card_y, real = [], [], q.instance_norm

    def spy(x, *a, **kw):
        y = real(x, *a, **kw)
        card_x.append(x.cpu())
        card_y.append(y.cpu())
        return y

    before = cuda_norm.instance_norm_fwd.launches
    with mock.patch.object(q, "instance_norm", spy):
        got = sty.stylize_u8(img)
    assert cuda_norm.instance_norm_fwd.launches - before == 14
    cpu_x, card_in = [], iter(card_y)

    def forced(x, *a, **kw):
        cpu_x.append(x)
        return next(card_in)

    with mock.patch.object(q, "instance_norm", forced):
        out = cpu.stylize_u8(img)
    assert len(cpu_x) == 14
    for i, (x_cpu, x_card) in enumerate(zip(cpu_x, card_x)):
        assert torch.equal(x_cpu, x_card), f"IN site {i}: the conv before it differs"
    np.testing.assert_array_equal(out, got)
    want = cpu.stylize_u8(img)
    assert min(ssim(a / 255.0, b / 255.0) for a, b in zip(got, want)) >= 0.98


@pytest.mark.gpu
def test_onnx_runtime_on_card(tmp_path):
    """The exported trained stylizer through the port's ONNX runtime on the
    card against the f32 Stylizer there (TF32 off): u8 max |delta| <= 1,
    and 14 IN forward kernel launches (relu=False, Relu is its own node)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from fast_neural_style_transfer_tpu_torch.export.onnx_export import build_onnx_model
    from fast_neural_style_transfer_tpu_torch.export.onnx_runtime import run_model
    from fast_neural_style_transfer_tpu_torch.utils.image_io import network_to_u8

    sty = Stylizer.from_checkpoint(str(_CHECKPOINT), precision="f32", device="cuda")
    data = build_onnx_model(Stylizer.load_params(str(_CHECKPOINT)),
                            input_shape=("batch", 3, "height", "width"))
    x = np.random.default_rng(0).standard_normal((2, 128, 192, 3)).astype(np.float32)
    before = cuda_norm.instance_norm_fwd.launches
    (out,) = run_model(data, {"input_image": np.transpose(x, (0, 3, 1, 2))}, device="cuda")
    assert cuda_norm.instance_norm_fwd.launches - before == 14
    got = network_to_u8(out.permute(0, 2, 3, 1)).cpu().numpy().astype(int)
    want = network_to_u8(torch.from_numpy(sty(x))).numpy().astype(int)
    assert np.abs(got - want).max() <= 1


# the sharded IN modes (ROADMAP row 15a): (n, c, h, w, active rows), the
# last a slab above the one-launch capacity with an extent
_SHARD_CASES = [(1, 64, 96, 80, 96), (2, 256, 32, 24, 30), (1, 32, 1024, 640, 1000)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("affine", ["channel", "sample"])
def test_sharded_forward_modes_match_plain_on_card(dtype, affine):
    """The statistics-only route and the sharded apply against their plain
    versions, each launched once a call and repeating bit for bit; rows past
    the extent come out as relu(beta)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(1)
    for n, c, h, w, rows in _SHARD_CASES:
        x, g, b = _site_inputs(rng, n, h, w, c, dt)
        if affine == "sample":
            g, b = g.expand(n, c).contiguous() + 0.1, b.expand(n, c).contiguous()
        modes = dict(cuda_norm.instance_norm_fwd.launches_by_mode)
        with torch.inference_mode():
            mean, var = cuda_norm.instance_norm_moments(x, rows)
            again = cuda_norm.instance_norm_moments(x, rows)
            mean_r, var_r = cuda_norm._moments(x[:, :, :rows].float(), False)
            y, inv = cuda_norm.instance_norm_apply_global(x, g, b, mean_r, var_r,
                                                          rows=rows, relu=True)
            y2, _ = cuda_norm.instance_norm_apply_global(x, g, b, mean_r, var_r,
                                                         rows=rows, relu=True)
            y_r, _ = cuda_norm.instance_norm_apply_global_reference(
                x, g, b, mean_r, var_r, rows=rows, relu=True)
        after = cuda_norm.instance_norm_fwd.launches_by_mode
        assert after["stats"] - modes["stats"] == 2
        assert after["sharded_apply"] - modes["sharded_apply"] == 2
        assert torch.equal(mean, again[0]) and torch.equal(var, again[1])
        assert torch.equal(y, y2)
        torch.testing.assert_close(mean, mean_r, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(var, var_r, rtol=1e-4, atol=0)
        tol = dict(rtol=1e-4, atol=1e-4) if dtype == "float32" else \
            dict(rtol=1 / 128, atol=1e-2)
        torch.testing.assert_close(y.float(), y_r.float(), **tol)
        torch.testing.assert_close(inv, torch.rsqrt(var_r + 1e-5), rtol=1e-6, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("relu", [False, True])
def test_sharded_backward_passes_match_plain_on_card(dtype, relu):
    """The sharded backward's sums and apply against their plain versions
    ((C,) and (N, C) affines), launched once a call, bit for bit again."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(2)
    for n, c, h, w, _ in _SHARD_CASES[:2]:
        x, g, b = _site_inputs(rng, n, h, w, c, dt)
        gy = torch.from_numpy(rng.standard_normal((n, c, h, w)).astype(np.float32))
        gy = gy.to("cuda", dt).contiguous(memory_format=torch.channels_last)
        mean, var = cuda_norm._moments(x.float(), False)
        inv = torch.rsqrt(var + 1e-5)
        for gam, bet in ((g, b), (g.expand(n, c).contiguous(), b.expand(n, c).contiguous())):
            args = (x, gy, mean, inv, gam, bet)
            modes = dict(cuda_norm.instance_norm_bwd.launches_by_mode)
            sums = cuda_norm.instance_norm_bwd_sums(*args, relu=relu)
            again = cuda_norm.instance_norm_bwd_sums(*args, relu=relu)
            sums_r = cuda_norm.instance_norm_bwd_sums_reference(*args, relu=relu)
            dx = cuda_norm.instance_norm_bwd_apply(*args, *sums_r, 3 * h * w, relu=relu)
            dx2 = cuda_norm.instance_norm_bwd_apply(*args, *sums_r, 3 * h * w, relu=relu)
            dx_r = cuda_norm.instance_norm_bwd_apply_reference(*args, *sums_r, 3 * h * w,
                                                               relu=relu)
            after = cuda_norm.instance_norm_bwd.launches_by_mode
            assert after["bwd_sums"] - modes["bwd_sums"] == 2
            assert after["bwd_apply"] - modes["bwd_apply"] == 2
            assert all(torch.equal(a, b2) for a, b2 in zip(sums, again))
            assert torch.equal(dx, dx2)
            for a, r in zip(sums, sums_r):
                torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-3 * r.abs().max().item())
            top = dx_r.float().abs().max().item()
            tol = dict(rtol=1e-4, atol=1e-4 * top) if dtype == "float32" else \
                dict(rtol=1 / 128, atol=1e-3 * top)
            torch.testing.assert_close(dx.float(), dx_r.float(), **tol)


def test_sharded_modes_take_the_plain_versions_on_the_cpu():
    """On a CPU tensor the sharded modes run their plain versions and
    launch nothing."""
    x = torch.randn(2, 8, 6, 5).contiguous(memory_format=torch.channels_last)
    g, b = torch.rand(8) + 0.5, torch.randn(8)
    fwd = dict(cuda_norm.instance_norm_fwd.launches_by_mode)
    bwd = dict(cuda_norm.instance_norm_bwd.launches_by_mode)
    mean, var = cuda_norm.instance_norm_moments(x, 4)
    torch.testing.assert_close(mean, x[:, :, :4].mean(dim=(2, 3)))
    y, inv = cuda_norm.instance_norm_apply_global(x, g, b, mean, var, rows=4, relu=True)
    assert torch.equal(y[:, :, 4:], torch.relu(b)[None, :, None, None].expand(2, 8, 2, 5))
    sums = cuda_norm.instance_norm_bwd_sums(x, x, mean, inv, g, b)
    cuda_norm.instance_norm_bwd_apply(x, x, mean, inv, g, b, *sums, 30)
    assert cuda_norm.instance_norm_fwd.launches_by_mode == fwd
    assert cuda_norm.instance_norm_bwd.launches_by_mode == bwd


def test_sharded_plans_fill_the_card():
    """A shard of one large sample (a 4K image's rows, 256 channels): the
    statistics pass and the apply take ~4 blocks an SM, not the 32 blocks
    the two-launch forward's merge budget would give them."""
    kw = dict(sms=132, blocks_per_sm=2, one_launch=False)
    hw = 270 * 960
    assert cuda_norm.plan_fwd(1, hw, 256, 4, 4, **kw).chunks == 32
    assert cuda_norm.plan_fwd(1, hw, 256, 4, 4, sharded=True, **kw).chunks == 528
    assert cuda_norm.plan_fwd(2, hw, 256, 4, 4, sharded=True, **kw).chunks == 264


class _Guard:
    """``torch.cuda.device`` stand-in: records the device each block enters
    and which one is current."""

    def __init__(self):
        self.entered, self.current = [], None

    def __call__(self, device):
        guard = self

        class _Block:
            def __enter__(self):
                guard.entered.append(device)
                guard.current = device

            def __exit__(self, *exc):
                guard.current = None

        return _Block()


def _fake_lib(guard, calls, names):
    """A C library whose entry points record the guarded device they run
    under (None: no guard) and succeed."""

    def entry(name):
        def fn(*args):
            calls.append((name, guard.current))
            return 0
        return fn

    return types.SimpleNamespace(**{n: entry(n) for n in names})


def test_wrappers_launch_under_a_guard_for_the_tensors_device(monkeypatch):
    """Every launch and the conv occupancy query run with the runtime's
    current device set to the tensor's (``ops/_build.py::on_card``), on that
    device's stream: here CPU tensors reach the launch code with the C
    library, ``torch.cuda.device`` and the stream faked."""
    guard, calls = _Guard(), []
    monkeypatch.setattr(torch.cuda, "device", guard)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=7, device=d))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(multi_processor_count=132))
    monkeypatch.setattr(cuda_norm, "_kernels", lambda: _fake_lib(
        guard, calls, ["fwd", "fwd_stats", "bwd", "bwd_sums", "bwd_apply"]))
    lib = _fake_lib(guard, calls, ["bwd", "dx"])
    lib.dx_occupancy = lambda *a: calls.append(("dx_occupancy", guard.current)) or 2
    lib.bwd_smem = lambda *a: 0
    monkeypatch.setattr(cuda_conv, "_kernel", lambda: lib)
    monkeypatch.setattr(cuda_conv, "_occupancy", {})
    x = torch.randn(2, 64, 8, 8).contiguous(memory_format=torch.channels_last)
    g, b = torch.ones(64), torch.zeros(64)
    m = torch.zeros(2, 64)
    fplan = cuda_norm.plan_fwd(2, 64, 64, 4, 4, sms=132, blocks_per_sm=2)
    cuda_norm._launch_fwd(x, g, b, fplan, eps=1e-5, relu=True, onepass=False)
    bplan = cuda_norm.plan_bwd(2, 64, 64, 4, 4, sms=132, blocks_per_sm=2)
    cuda_norm._launch_bwd(x, x, m, m, g, b, bplan, relu=True)
    gy = torch.randn(2, 64, 8, 8).contiguous(memory_format=torch.channels_last)
    w = torch.randn(64, 3, 3, 3)
    cuda_conv._launch_dx(gy, w, cuda_conv.conv_dx_plan(gy, w))
    cuda_conv._launch_dx(gy, w, cuda_conv.conv_dx_plan(gy, w, tap_packed=False))
    assert [c[0] for c in calls] == ["fwd", "bwd", "dx_occupancy", "dx", "bwd"]
    assert all(c[1] == x.device for c in calls), calls
    assert all(d == x.device for d in guard.entered) and len(guard.entered) == len(calls)


def test_every_c_call_of_the_wrappers_is_guarded():
    """In ``ops/cuda_norm.py`` and ``ops/cuda_conv.py`` every entry point of
    the C library is either handed to ``_build.on_card`` or called inside a
    ``with torch.cuda.device(...)`` block, bar the pure shared-memory size
    queries and the binding of the library; no stream is fetched outside
    ``on_card``."""
    handles = {"_kernels", "_kernel"}
    for path in ("ops/cuda_norm.py", "ops/cuda_conv.py"):
        src = (PORT_DIR / path).read_text()
        assert "current_stream" not in src, path
        tree = ast.parse(src)
        guarded = set()
        for node in ast.walk(tree):  # the binding functions call nothing
            if isinstance(node, ast.FunctionDef) and node.name in handles:
                guarded |= {id(n) for n in ast.walk(node)}
            if isinstance(node, ast.With) and any(
                    ast.unparse(item.context_expr).startswith("torch.cuda.device(")
                    for item in node.items):
                guarded |= {id(n) for n in ast.walk(node)}
            if isinstance(node, ast.Call) and ast.unparse(node.func) == "_build.on_card":
                guarded |= {id(a) for a in node.args[1:2]}
        entries = 0
        for node in ast.walk(tree):
            if not isinstance(node, ast.Attribute) or (
                    isinstance(node.value, ast.Name) and node.value.id == "lib"
                    and node.attr.startswith("fnst_")):
                continue
            base = node.value
            is_lib = (isinstance(base, ast.Call) and ast.unparse(base.func) in handles) or (
                isinstance(base, ast.Name) and base.id == "lib")
            if not is_lib or node.attr.endswith("smem"):
                continue
            entries += 1
            assert id(node) in guarded, f"{path}: {ast.unparse(node)} runs unguarded"
        assert entries == (7 if path.endswith("norm.py") else 3), (path, entries)


# (N, H, W) of the stylizer's final-conv outputs on the main path: serving
# batches at 256^2 and 512^2, an inference-CLI size; and beside them the
# smallest side, a strip boundary and a ragged width
_RGB_SHAPES = ([(n, s, s) for s in (256, 512) for n in (1, 2, 5, 8)]
               + [(1, 260, 388), (1, 5, 5), (2, 9, 121), (1, 33, 250)])


@pytest.mark.gpu
def test_final_conv_kernel_matches_plain_on_card():
    """The final-conv kernel (``ops/cuda_conv_rgb.py``) against its plain
    version (float32 F.conv2d of the same bf16 operands): one launch each,
    every output within one bf16 rounding step of the plain one (2^-7 of
    its size; 1e-4 near 0: the two sum 2592 exact products in other
    orders, then round once)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.inference_mode():
        for n, h, w in _RGB_SHAPES:
            x = torch.relu(torch.randn((n, h, w, 32), generator=gen, device="cuda")).bfloat16()
            xp = cuda_pad.reflect_pad(x.permute(0, 3, 1, 2), 4)
            wt = (torch.randn((3, 32, 9, 9), generator=gen, device="cuda") * 0.02).bfloat16()
            wt = wt.contiguous(memory_format=torch.channels_last)
            b = (torch.randn(3, generator=gen, device="cuda") * 0.1).bfloat16()
            for bias in (b, None):
                before = cuda_conv_rgb.conv_to_rgb.launches
                y = cuda_conv_rgb.conv_to_rgb(xp, wt, bias)
                assert cuda_conv_rgb.conv_to_rgb.launches == before + 1
                torch.cuda.synchronize()
                want = cuda_conv_rgb.conv_to_rgb_reference(xp, wt, bias).float()
                assert y.shape == (n, 3, h, w) and y.is_contiguous(
                    memory_format=torch.channels_last)
                gap = (y.float() - want).abs() - (2.0 ** -7 * want.abs() + 1e-4)
                assert gap.max().item() <= 0, (n, h, w, bias is None)


@pytest.mark.gpu
def test_final_conv_launches_once_a_bf16_forward_replays_included_on_card():
    """A bf16 Stylizer forward launches the kernel once, eager or replayed
    from its CUDA graph, and gives the same bytes either way; a float32
    forward launches it never."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.manual_seed(0)
    params = TransformerNet().state_dict()
    x = np.random.default_rng(0).integers(0, 256, (2, 128, 128, 3), np.uint8)
    sty = Stylizer(params, precision="bf16", device="cuda")
    counts, outs = [], []
    for _ in range(4):  # eager, eager + capture, replay, replay
        before = cuda_conv_rgb.conv_to_rgb.launches
        outs.append(sty.stylize_u8(x))
        counts.append(cuda_conv_rgb.conv_to_rgb.launches - before)
    assert counts == [1, 1, 1, 1] and sty.graph_replays == 2
    assert all(np.array_equal(o, outs[0]) for o in outs)
    f32 = Stylizer(params, precision="f32", device="cuda")
    before = cuda_conv_rgb.conv_to_rgb.launches
    f32.stylize_u8(x)
    assert cuda_conv_rgb.conv_to_rgb.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wrappers_launch_on_the_tensors_card(dtype):
    """Each wrapper on cuda:1 while cuda:0 is current: the kernels run on
    card 1 and match their plain versions there."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(1)
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 1)
    x = torch.from_numpy(rng.standard_normal((2, 64, 32, 32)).astype(np.float32))
    x = x.to(dev, dt).contiguous(memory_format=torch.channels_last)
    g = torch.from_numpy(rng.standard_normal(64).astype(np.float32)).to(dev)
    b = torch.from_numpy(rng.standard_normal(64).astype(np.float32)).to(dev)
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == "float32" else dict(rtol=1 / 64, atol=2e-2)
    with torch.inference_mode():
        y, mean, inv = cuda_norm.instance_norm_fwd(x, g, b, relu=True)
        y_r, _, _ = cuda_norm.instance_norm_fwd_reference(x.float(), g, b, relu=True)
        torch.testing.assert_close(y.float(), y_r, **tol)
        gy = torch.from_numpy(rng.standard_normal((2, 64, 32, 32)).astype(np.float32))
        gy = gy.to(dev, dt).contiguous(memory_format=torch.channels_last)
        dx, dg, db = cuda_norm.instance_norm_bwd(x, gy, mean, inv, g, b, relu=True)
        dx_r, _, _ = cuda_norm.instance_norm_bwd_reference(x.float(), gy.float(), mean,
                                                           inv, g, b, relu=True)
        top = dx_r.abs().max().item()
        torch.testing.assert_close(dx.float(), dx_r, rtol=tol["rtol"], atol=1e-3 * top)
        rows = cuda_norm.instance_norm_moments(x, 16)[0]
        torch.testing.assert_close(rows, x[:, :, :16].float().mean(dim=(2, 3)),
                                   rtol=1e-4, atol=1e-4)
        gc = torch.from_numpy(rng.standard_normal((2, 64, 32, 32)).astype(np.float32))
        gc = gc.to(dev, dt).contiguous(memory_format=torch.channels_last)
        w = torch.from_numpy(rng.standard_normal((64, 3, 3, 3)).astype(np.float32)).to(dev, dt)
        dxc = cuda_conv.conv2d_same_dx(gc, w)
        dxc_r = cuda_conv.conv2d_same_dx_reference(gc.float(), w.float())
        torch.testing.assert_close(dxc.float(), dxc_r, rtol=tol["rtol"],
                                   atol=1e-3 * dxc_r.abs().max().item())
    assert torch.cuda.current_device() == 0
    assert y.device == dx.device == dxc.device == dev


@pytest.mark.gpu
@pytest.mark.parametrize("transport", ["u8", "f32"])
def test_prefetched_batches_keep_their_buffers_on_card(tmp_path, transport):
    """Two batches in flight each keep their pinned buffer, device tensor
    and event: every batch of two epochs, all held at once and read after
    work queued on the consumer's stream, equals its host batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from PIL import Image

    from fast_neural_style_transfer_tpu_torch.data import ImageFolderDataset, InputPipeline

    rng = np.random.default_rng(0)
    for i in range(10):
        Image.fromarray(rng.integers(0, 256, (70, 90, 3), dtype=np.uint8)).save(
            tmp_path / f"{i}.jpg")
    ds = ImageFolderDataset(str(tmp_path), (64, 64), seed=0)
    pipe = InputPipeline(ds, 4, num_workers=2, prefetch=2, transport=transport,
                         device="cuda")
    want = list(pipe.host_batches(num_epochs=2))
    held = []
    for b in pipe.device_batches(num_epochs=2):
        held.append(b)
        torch.cuda._sleep(1_000_000)  # the consumer's stream lags the copies
    assert len(held) == len(want) == 4
    for b, w in zip(held, want):
        np.testing.assert_array_equal(b.cpu().numpy(), w)
