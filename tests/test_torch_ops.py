"""The port's ops, and their gradients, against the JAX package's on the CPU.

Inputs come from a numpy seed and reach both sides as numpy arrays. The
port's tensors are (N, C, H, W) in channels_last memory format; the JAX
side is NHWC. Tolerances (f32): 1e-5 absolute where both sides run the same
arithmetic on at most a few hundred elements per reduction; convs compare
at 1e-4 since XLA and PyTorch sum k*k*C_in products in other orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_neural_style_transfer_tpu.core import shapes as jshapes
from fast_neural_style_transfer_tpu.ops import conv as jconv
from fast_neural_style_transfer_tpu.ops import gram as jgram
from fast_neural_style_transfer_tpu.ops import norm as jnorm
from fast_neural_style_transfer_tpu.ops import pallas_conv
from fast_neural_style_transfer_tpu.ops.pallas_norm import (
    _pallas_in_backward,
    _pallas_in_forward,
    fused_instance_norm,
)
from fast_neural_style_transfer_tpu.utils import color as jcolor
from fast_neural_style_transfer_tpu.utils import image_io as jio
from fast_neural_style_transfer_tpu.utils.ssim import ssim as jax_ssim
from fast_neural_style_transfer_tpu_torch.core import shapes as tshapes
from fast_neural_style_transfer_tpu_torch.ops import conv as tconv
from fast_neural_style_transfer_tpu_torch.ops import cuda_conv, cuda_norm, norm as tnorm
from fast_neural_style_transfer_tpu_torch.ops.gram import gram_matrix
from fast_neural_style_transfer_tpu_torch.utils import color as tcolor
from fast_neural_style_transfer_tpu_torch.utils import image_io as tio
from fast_neural_style_transfer_tpu_torch.utils.ssim import ssim as torch_ssim


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs with several xdist workers
    yield
    torch.set_num_threads(prev)


def to_nchw(a: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, np.float32)).to(dtype)
    return t.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def to_nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).float().numpy()


def _in_inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 3 + 0.5).astype(np.float32)
    gamma = rng.standard_normal(shape[-1]).astype(np.float32)
    beta = rng.standard_normal(shape[-1]).astype(np.float32)
    return x, gamma, beta


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape", [(2, 8, 8, 32), (2, 4, 6, 256)])
def test_instance_norm_matches_xla_stable(shape, relu):
    x, gamma, beta = _in_inputs(shape)
    want = jnorm._xla_instance_norm(jnp.asarray(x), jnp.asarray(gamma),
                                    jnp.asarray(beta), eps=1e-5, relu=relu)
    got = tnorm.instance_norm(to_nchw(x), torch.from_numpy(gamma),
                              torch.from_numpy(beta), relu=relu)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), rtol=0, atol=1e-5)


def test_instance_norm_bf16_matches_xla():
    # bf16 in and out, f32 statistics on both sides: the outputs differ by
    # at most one bf16 rounding (2^-8 relative, so 1/128 covers one ulp)
    x, gamma, beta = _in_inputs((2, 8, 8, 64), seed=1)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = jnorm._xla_instance_norm(xb, jnp.asarray(gamma), jnp.asarray(beta),
                                    eps=1e-5, relu=True)
    xt = to_nchw(np.asarray(xb.astype(jnp.float32)), torch.bfloat16)
    got = tnorm.instance_norm(xt, torch.from_numpy(gamma),
                              torch.from_numpy(beta), relu=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want, np.float32),
                               rtol=1 / 128, atol=1e-2)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape", [(2, 8, 8, 32), (2, 4, 6, 256)])
def test_onepass_matches_pallas_kernel_interpret(shape, relu):
    """The plain version's one-pass mode is the TPU kernel's arithmetic:
    (y, mean, inv) against _pallas_in_forward in interpret mode, f32."""
    x, gamma, beta = _in_inputs(shape, seed=2)
    y_j, mean_j, inv_j = _pallas_in_forward(
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta),
        eps=1e-5, relu=relu, interpret=True)
    y_t, mean_t, inv_t = cuda_norm.instance_norm_fwd(
        to_nchw(x), torch.from_numpy(gamma), torch.from_numpy(beta),
        relu=relu, onepass=True)
    np.testing.assert_allclose(to_nhwc(y_t), np.asarray(y_j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(mean_t.numpy(), np.asarray(mean_j)[:, 0],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(inv_t.numpy(), np.asarray(inv_j)[:, 0],
                               rtol=1e-5, atol=0)


@pytest.mark.parametrize("method", ["stable", "onepass"])
def test_stats_and_apply_match_jax(method):
    x, gamma, beta = _in_inputs((2, 6, 10, 16), seed=3)
    m_j, v_j = jnorm.instance_norm_stats(jnp.asarray(x), method=method)
    m_t, v_t = tnorm.instance_norm_stats(to_nchw(x), method=method)
    np.testing.assert_allclose(m_t.numpy()[:, :, 0, 0], np.asarray(m_j)[:, 0, 0],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(v_t.numpy()[:, :, 0, 0], np.asarray(v_j)[:, 0, 0],
                               rtol=1e-5, atol=1e-6)
    y_j = jnorm.apply_instance_norm_stats(jnp.asarray(x), m_j, v_j,
                                          jnp.asarray(gamma), jnp.asarray(beta),
                                          relu=True)
    y_t = tnorm.apply_instance_norm_stats(to_nchw(x), m_t, v_t,
                                          torch.from_numpy(gamma),
                                          torch.from_numpy(beta), relu=True)
    np.testing.assert_allclose(to_nhwc(y_t), np.asarray(y_j), rtol=0, atol=1e-5)


def test_cpu_wrapper_counts_no_launch():
    x, gamma, beta = _in_inputs((1, 4, 4, 8))
    before = cuda_norm.instance_norm_fwd.launches
    cuda_norm.instance_norm_fwd(to_nchw(x), torch.from_numpy(gamma),
                                torch.from_numpy(beta))
    assert cuda_norm.instance_norm_fwd.launches == before


@pytest.mark.parametrize("k,stride,cin,cout,hw", [
    (9, 2, 3, 64, (20, 24)),
    (3, 1, 16, 24, (9, 11)),
    (3, 2, 16, 32, (12, 10)),
])
def test_reflect_conv2d_matches_jax_direct(k, stride, cin, cout, hw):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, *hw, cin)).astype(np.float32)
    w = (rng.standard_normal((k, k, cin, cout)) / (k * np.sqrt(cin))).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    want = jconv.reflect_conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                stride=stride, lowering="direct")
    w_oihw = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
    got = tconv.reflect_conv2d(to_nchw(x), w_oihw, torch.from_numpy(b),
                               stride=stride)
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cin,cout,hw", [(32, 16, (5, 7)), (16, 8, (8, 8))])
def test_conv_transpose2d_matches_jax_direct(cin, cout, hw):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, *hw, cin)).astype(np.float32)
    w = (rng.standard_normal((3, 3, cin, cout)) / (3 * np.sqrt(cin))).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    want = jconv.conv_transpose2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                  stride=2, padding=1, output_padding=1,
                                  lowering="direct")
    w_iohw = torch.from_numpy(np.ascontiguousarray(w.transpose(2, 3, 0, 1)))
    got = tconv.conv_transpose2d(to_nchw(x), w_iohw, torch.from_numpy(b),
                                 stride=2, padding=1, output_padding=1)
    assert got.shape[2:] == (2 * hw[0], 2 * hw[1])
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("hw,multiple", [((40, 52), 64), ((3, 70), 64), ((64, 64), 64),
                                         ((33, 17), 32)])
def test_pad_to_multiple_reflect_matches_jax(hw, multiple):
    rng = np.random.default_rng(6)
    x = rng.integers(0, 256, (2, *hw, 3), dtype=np.uint8)
    want, want_hw = jshapes.pad_to_multiple_reflect(jnp.asarray(x), multiple)
    got, got_hw = tshapes.pad_to_multiple_reflect(torch.from_numpy(x), multiple)
    assert got_hw == want_hw and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tshapes.bucket_hw(*hw, multiple) == jshapes.bucket_hw(*hw, multiple)


def test_u8_network_roundtrip_matches_jax():
    rng = np.random.default_rng(7)
    x = rng.integers(0, 256, (1, 9, 7, 3), dtype=np.uint8)
    np.testing.assert_allclose(tio.u8_to_network(torch.from_numpy(x)).numpy(),
                               np.asarray(jio.u8_to_network_jnp(jnp.asarray(x))),
                               rtol=0, atol=1e-6)
    y = (rng.standard_normal((1, 9, 7, 3)) * 2).astype(np.float32)
    np.testing.assert_array_equal(tio.network_to_u8(torch.from_numpy(y)).numpy(),
                                  np.asarray(jio.network_to_u8_jnp(jnp.asarray(y))))


def test_luminance_transfer_and_ssim_match_jax():
    rng = np.random.default_rng(8)
    s = rng.random((2, 12, 14, 3)).astype(np.float32)
    c = rng.random((2, 12, 14, 3)).astype(np.float32)
    want = jcolor.luminance_transfer(jnp.asarray(s), jnp.asarray(c))
    got = tcolor.luminance_transfer(torch.from_numpy(s), torch.from_numpy(c))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert torch_ssim(s, c) == jax_ssim(s, c)


_SMS = 132  # an H100's SMs, for the forward's planner


def _fold(lanes):
    """The kernels' fixed tree over lanes (axis 0, float32): lanes [half, L)
    are added onto [0, L - half), half = ceil(L / 2), until one is left."""
    v = np.array(lanes, np.float32)
    n = v.shape[0]
    while n > 1:
        half = (n + 1) // 2
        v[:n - half] = v[:n - half] + v[half:n]
        n = half
    return v[0]


def _lane_sum(vals, slots):
    """Sum over axis 1 as the kernels add (lane_sum, 256 threads a block of
    slots x lanes): lane l takes rows l, l + lanes, ... in order (float32);
    where slots is a power of two below 32, each warp's 32 / slots lanes
    fold first, then the 8 warps' sums; else all lanes (empty ones are 0)
    fold."""
    lanes = 256 // slots
    zero = np.zeros(vals.shape[:1] + vals.shape[2:], np.float32)
    sums = [vals[:, lane::lanes].cumsum(axis=1, dtype=np.float32)[:, -1]
            if lane < vals.shape[1] else zero for lane in range(lanes)]
    if slots < 32 and slots & (slots - 1) == 0:
        per_warp = 32 // slots
        return _fold([_fold(sums[w * per_warp:(w + 1) * per_warp]) for w in range(8)])
    return _fold(sums)


def _emulate_kernel(x, gamma, beta, *, relu, onepass, route, eps=1e-5):
    """numpy emulation of the CUDA forward's reduction (float32), with the
    planner's chunks on a 132-SM card holding two one-launch blocks per SM:
    per chunk, lane sums over the pixels (one launch: the chunk mean, then
    the squared deviations about it; two launches: sums shifted by the
    chunk's first pixel; one-pass: sums and sums of squares), then the
    chunks merged about chunk 0's mean (merge_chunks: one launch, each
    block j its slice of ceil(C / G) channels; two launches, all C at
    once), lanes over the chunks folded in the kernels' tree. Pixel rows of
    no more packs, and no more channels, than a block has threads."""
    n, h, w, c = x.shape
    hw, f32 = h * w, np.float32
    xs = x.reshape(n, hw, c).astype(f32)
    vec = cuda_norm.pack_vec(c, 4, 0)
    plan = cuda_norm.plan_fwd(n, hw, c, 4, vec, sms=_SMS,
                              blocks_per_sm=2, one_launch=route == "one_launch")
    assert plan.route == route
    packs = c // vec
    a_parts, b_parts, counts = [], [], []
    for j in range(plan.chunks):
        xc = xs[:, j * plan.chunk:(j + 1) * plan.chunk]
        cnt = f32(xc.shape[1])
        if onepass:
            a, b = _lane_sum(xc, packs), _lane_sum(xc * xc, packs)
        elif route == "one_launch":
            a = _lane_sum(xc, packs) / cnt
            b = _lane_sum(np.square(xc - a[:, None]), packs)
        else:
            d = xc - xc[:, :1]
            s1, s2 = _lane_sum(d, packs), _lane_sum(d * d, packs)
            dm = s1 / cnt
            a, b = xc[:, 0] + dm, np.maximum(s2 - s1 * dm, 0)
        a_parts.append(a)
        b_parts.append(b)
        counts.append(cnt)
    a_parts, b_parts = np.stack(a_parts, 1), np.stack(b_parts, 1)
    nj = np.asarray(counts, f32)[None, :, None]
    if route == "one_launch":
        per = 1  # a power of two
        while per * plan.chunks < c:
            per *= 2
        slices = [(j * per, min(c, (j + 1) * per)) for j in range(plan.chunks) if j * per < c]
    else:
        slices = [(0, c)]
    mean, var = np.zeros((n, c), f32), np.zeros((n, c), f32)
    fhw = f32(hw)
    for c0, c1 in slices:
        m_slots = c1 - c0  # the merge's slots: its channels
        pa, pb = a_parts[:, :, c0:c1], b_parts[:, :, c0:c1]
        if onepass:
            s1, s2 = _lane_sum(pa, m_slots), _lane_sum(pb, m_slots)
            mean[:, c0:c1] = s1 / fhw
            var[:, c0:c1] = np.maximum(s2 / fhw - np.square(s1 / fhw), 0)
        else:
            k = pa[:, 0]
            d = pa - k[:, None]
            s1 = _lane_sum(nj * d, m_slots)
            s2 = _lane_sum(pb + nj * d * d, m_slots)
            dm = s1 / fhw
            mean[:, c0:c1] = k + dm
            var[:, c0:c1] = np.maximum(s2 - s1 * dm, 0) / fhw
    inv = (1 / np.sqrt(var + f32(eps))).astype(f32)
    scale = inv * gamma
    y = xs * scale[:, None] + (beta - mean * scale)[:, None]
    if relu:
        y = np.maximum(y, 0)
    return y.reshape(x.shape), mean, inv


@pytest.mark.parametrize("route", ["one_launch", "two_launch"])
@pytest.mark.parametrize("onepass", [False, True])
@pytest.mark.parametrize("shape", [(2, 32, 32, 40), (1, 30, 35, 64), (3, 4, 5, 8)])
def test_kernel_reduction_emulation_matches_plain(shape, onepass, route):
    """The forward kernels' chunked reductions and their merges, emulated on
    the CPU, agree with the plain version (f32; sums taken in another
    order, so 1e-5)."""
    x, gamma, beta = _in_inputs(shape, seed=9)
    y_e, mean_e, inv_e = _emulate_kernel(x, gamma, beta, relu=True,
                                         onepass=onepass, route=route)
    y_r, mean_r, inv_r = cuda_norm.instance_norm_fwd_reference(
        to_nchw(x), torch.from_numpy(gamma), torch.from_numpy(beta),
        relu=True, onepass=onepass)
    np.testing.assert_allclose(mean_e, mean_r.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(inv_e, inv_r.numpy(), rtol=1e-4, atol=0)
    np.testing.assert_allclose(y_e, to_nhwc(y_r), rtol=1e-4, atol=1e-4)


_SITE_HWC = [(128, 128, 64), (64, 64, 256), (256, 256, 32)]


@pytest.mark.parametrize("itemsize", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [1, 8, 20])
@pytest.mark.parametrize("hwc", _SITE_HWC)
def test_fwd_plan_at_site_shapes(hwc, n, itemsize):
    """Every IN site of the 256^2 paths takes the one-launch kernel, on a
    132-SM card holding two of its blocks per SM: chunks of whole pixel
    rows within the byte budget and the shared memory, G within the
    capacity, chunks that cover H*W exactly, at least a block per SM."""
    h, w, c = hwc
    hw = h * w
    plan = cuda_norm.plan_fwd(n, hw, c, itemsize, 16 // itemsize,
                              sms=_SMS, blocks_per_sm=2)
    assert plan.route == "one_launch"
    assert plan.chunk_bytes == plan.chunk * c * itemsize <= cuda_norm._FWD_CHUNK_BYTES
    assert plan.smem_bytes == cuda_norm.fwd_smem_bytes(plan.chunk, c, itemsize, plan.vec)
    assert plan.smem_bytes <= cuda_norm._SMEM_LIMIT
    assert 1 <= plan.chunks <= plan.capacity == 2 * _SMS
    assert (plan.chunks - 1) * plan.chunk < hw <= plan.chunks * plan.chunk
    assert plan.blocks == n * plan.chunks >= _SMS


@pytest.mark.parametrize("itemsize", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [1, 8])
def test_fwd_plan_routes_large_slabs_to_two_launches(n, itemsize):
    """A 1024^2 x 32 slab (134 MB a sample in f32) has more chunks than the
    card holds at once: the two-launch kernel, with chunks that cover H*W
    and at most _FWD_PARTIALS partials a sample."""
    hw, c = 1024 * 1024, 32
    plan = cuda_norm.plan_fwd(n, hw, c, itemsize, 16 // itemsize,
                              sms=_SMS, blocks_per_sm=2)
    assert plan.route == "two_launch" and plan.smem_bytes == 0
    assert -(-hw * c * itemsize // cuda_norm._FWD_CHUNK_BYTES) > plan.capacity
    assert (plan.chunks - 1) * plan.chunk < hw <= plan.chunks * plan.chunk
    assert plan.chunks * c <= cuda_norm._FWD_PARTIALS
    assert plan.blocks >= _SMS


def test_fwd_plan_rules():
    """16-byte packs only where a pixel row is whole packs and x aligned;
    a one-launch block never exceeds its shared memory (a pixel row above
    the budget goes to two launches); ``one_launch=False`` and a card that
    holds no one-launch block take two launches."""
    assert cuda_norm.pack_vec(32, 4, 256) == 4 and cuda_norm.pack_vec(32, 2, 256) == 8
    assert cuda_norm.pack_vec(3, 4, 256) == 1 and cuda_norm.pack_vec(32, 4, 8) == 1
    plan = cuda_norm.plan_fwd(2, 50 * 70, 3, 4, 1, sms=132, blocks_per_sm=2)
    assert plan.route == "one_launch" and plan.vec == 1
    assert plan.smem_bytes <= cuda_norm._SMEM_LIMIT
    wide = cuda_norm.plan_fwd(1, 64, 2048, 4, 4, sms=132, blocks_per_sm=2)
    assert wide.route == "one_launch" and wide.smem_bytes <= cuda_norm._SMEM_LIMIT
    for kw in ({"one_launch": False}, {}):
        per_sm = 2 if kw else 0
        plan = cuda_norm.plan_fwd(8, 4096, 256, 2, 8, sms=132, blocks_per_sm=per_sm, **kw)
        assert plan.route == "two_launch"


@pytest.mark.parametrize("hwc", [(128, 128, 64), (64, 64, 256), (256, 256, 32)])
@pytest.mark.parametrize("n", [1, 8])
def test_kernel_chunking_at_site_shapes(n, hwc):
    """The IN backward's grid (``_num_chunks``; the forward has its own
    planner, ``plan_fwd``): at every IN site shape of a 256^2 forward it
    keeps >= 256 pixels per block, <= 64 partials per (sample, tile), and
    covers every pixel."""
    h, w, c = hwc
    hw = h * w
    chunks = cuda_norm._num_chunks(n, hw, -(-c // 32))
    chunk = -(-hw // chunks)
    assert 1 <= chunks <= 64 and chunk >= 256
    assert (chunks - 1) * chunk < hw <= chunks * chunk
    assert n * chunks * -(-c // 32) >= 64  # enough blocks for the card


# -- slice 2: gradients ---------------------------------------------------------
#
# IN backward: the plain version runs the TPU kernel's formula, so on the
# TPU kernel's own residuals it matches _pallas_in_backward (interpret mode)
# to 1e-5 in f32. Through InstanceNormFn the residuals are the port's
# two-pass statistics against the TPU kernel's one-pass ones, which differ
# in the last bits of inv: 1e-4. bf16: dx differs by at most one bf16 ulp
# (2^-7 relative) plus 1e-2 absolute at |dx| ~ 1, the rounding of dx and of
# the f32 terms ahead of it.

_IN_SHAPES = [(2, 8, 8, 32), (2, 4, 6, 256)]


def _grad_inputs(shape, dtype, seed):
    x, gamma, beta = _in_inputs(shape, seed=seed)
    gy = np.random.default_rng(seed + 100).standard_normal(shape).astype(np.float32)
    if dtype == "bfloat16":  # both sides see the same bf16 values
        x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
        gy = np.asarray(jnp.asarray(gy).astype(jnp.bfloat16).astype(jnp.float32))
    return x, gy, gamma, beta


def _tol(dtype, f32_atol):
    return (dict(rtol=0, atol=f32_atol) if dtype == "float32"
            else dict(rtol=2.0 ** -7, atol=1e-2))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape", _IN_SHAPES)
def test_in_bwd_plain_matches_pallas_kernel_interpret(shape, relu, dtype):
    x, gy, gamma, beta = _grad_inputs(shape, dtype, seed=11)
    jdt = getattr(jnp, dtype)
    xj, gj = jnp.asarray(x).astype(jdt), jnp.asarray(gy).astype(jdt)
    _, mean, inv = _pallas_in_forward(xj, jnp.asarray(gamma), jnp.asarray(beta),
                                      eps=1e-5, relu=relu, interpret=True)
    dx_j, dgn_j, dbn_j = _pallas_in_backward(xj, gj, mean, inv, jnp.asarray(gamma),
                                             jnp.asarray(beta), relu=relu,
                                             interpret=True)
    tdt = getattr(torch, dtype)
    dx_t, dgn_t, dbn_t = cuda_norm.instance_norm_bwd(
        to_nchw(x, tdt), to_nchw(gy, tdt), torch.from_numpy(np.array(mean)[:, 0]),
        torch.from_numpy(np.array(inv)[:, 0]), torch.from_numpy(gamma),
        torch.from_numpy(beta), relu=relu)
    assert dx_t.dtype == tdt and dx_t.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(to_nhwc(dx_t), np.asarray(dx_j, np.float32),
                               **_tol(dtype, 1e-5))
    np.testing.assert_allclose(dgn_t.numpy(), np.asarray(dgn_j)[:, 0], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(dbn_t.numpy(), np.asarray(dbn_j)[:, 0], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape", _IN_SHAPES)
def test_instance_norm_backward_on_cpu_matches_jax_vjp(shape, relu, dtype):
    """A CPU backward through ``instance_norm`` (InstanceNormFn, no card)
    against jax.vjp of the fused Pallas IN in interpret mode."""
    x, gy, gamma, beta = _grad_inputs(shape, dtype, seed=12)
    jdt = getattr(jnp, dtype)
    y_j, vjp = jax.vjp(
        lambda a, g_, b_: fused_instance_norm(a, g_, b_, 1e-5, relu, True),
        jnp.asarray(x).astype(jdt), jnp.asarray(gamma), jnp.asarray(beta))
    dx_j, dg_j, db_j = vjp(jnp.asarray(gy).astype(jdt))
    tdt = getattr(torch, dtype)
    xt = to_nchw(x, tdt).requires_grad_()
    gt = torch.from_numpy(gamma).requires_grad_()
    bt = torch.from_numpy(beta).requires_grad_()
    before = cuda_norm.instance_norm_bwd.launches
    y_t = tnorm.instance_norm(xt, gt, bt, relu=relu)
    dx_t, dg_t, db_t = torch.autograd.grad(y_t, (xt, gt, bt), to_nchw(gy, tdt))
    assert cuda_norm.instance_norm_bwd.launches == before  # the CPU takes the plain path
    assert dx_t.dtype == tdt and dg_t.dtype == torch.float32
    np.testing.assert_allclose(to_nhwc(y_t.detach()), np.asarray(y_j, np.float32),
                               **_tol(dtype, 1e-4))
    np.testing.assert_allclose(to_nhwc(dx_t), np.asarray(dx_j, np.float32),
                               **_tol(dtype, 1e-4))
    np.testing.assert_allclose(dg_t.numpy(), np.asarray(dg_j), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(db_t.numpy(), np.asarray(db_j), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("itemsize", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [1, 8, 20])
@pytest.mark.parametrize("hwc", _SITE_HWC)
def test_bwd_plan_at_site_shapes(hwc, n, itemsize):
    """Every IN site of the 256^2 training path takes the one-launch
    backward, on a 132-SM card holding two of its blocks per SM: chunks of
    whole pixel rows whose x and g past the register pixels fit the byte
    budget and the shared memory, G within the capacity, chunks that cover
    H*W exactly, at least a block per SM."""
    h, w, c = hwc
    hw = h * w
    plan = cuda_norm.plan_bwd(n, hw, c, itemsize, 16 // itemsize,
                              sms=_SMS, blocks_per_sm=2)
    assert plan.route == "one_launch" and plan.vec == 16 // itemsize
    assert plan.chunk_bytes == 2 * plan.chunk * c * itemsize
    shared = max(plan.chunk - cuda_norm.bwd_reg_pixels(c, plan.vec), 0)
    assert 2 * shared * c * itemsize <= cuda_norm._BWD_CHUNK_BYTES
    assert plan.smem_bytes == cuda_norm.bwd_smem_bytes(plan.chunk, c, itemsize, plan.vec)
    assert plan.smem_bytes <= cuda_norm._SMEM_LIMIT
    assert 1 <= plan.chunks <= plan.capacity == 2 * _SMS
    assert (plan.chunks - 1) * plan.chunk < hw <= plan.chunks * plan.chunk
    assert plan.blocks == n * plan.chunks >= _SMS


@pytest.mark.parametrize("itemsize,chunks", [(4, (66, 66, 132)), (2, (44, 52, 88))],
                         ids=["f32", "bf16"])
def test_bwd_plan_fills_waves_with_whole_samples(itemsize, chunks):
    """At the training batch the one-launch backward's blocks run in waves
    of the capacity (264): G = 264 // k, k the most whole samples a wave
    can hold, so no sample's chunks straddle two waves; f32 holds 4 pixels
    a lane in registers beside shared memory (4 samples a wave at 128^2 x 64
    and 64^2 x 256, 2 at 256^2 x 32), bf16 none (6, 5 and 3)."""
    got = tuple(cuda_norm.plan_bwd(20, h * w, c, itemsize, 16 // itemsize, sms=_SMS,
                                   blocks_per_sm=2).chunks for h, w, c in _SITE_HWC)
    assert got == chunks
    assert all(264 // g * g > 264 - g for g in got)


@pytest.mark.parametrize("itemsize", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [1, 2])
def test_bwd_plan_routes_large_slabs_to_two_launches(n, itemsize):
    """A 1024^2 x 32 slab (x + g 268 MB a sample in f32) has more chunks
    than the card holds at once: the two-launch kernel, element by element,
    with the chunks of ``_num_chunks`` covering H*W."""
    hw, c = 1024 * 1024, 32
    plan = cuda_norm.plan_bwd(n, hw, c, itemsize, 16 // itemsize,
                              sms=_SMS, blocks_per_sm=2)
    assert plan.route == "two_launch" and plan.smem_bytes == 0 and plan.vec == 1
    assert -(-hw * 2 * c * itemsize // cuda_norm._BWD_CHUNK_BYTES) > plan.capacity
    assert plan.chunks == cuda_norm._num_chunks(n, hw, 1)
    assert (plan.chunks - 1) * plan.chunk < hw <= plan.chunks * plan.chunk
    assert plan.blocks == n * plan.chunks


def test_bwd_plan_rules():
    """16-byte packs only where a pixel row is whole packs and both x and g
    are aligned; a one-launch block never exceeds its shared memory (a
    pixel row of x and g above the budget goes to two launches);
    ``one_launch=False`` and a card that holds no one-launch block take
    two launches."""
    assert cuda_norm.pack_vec(32, 4, 256, 512) == 4
    assert cuda_norm.pack_vec(32, 2, 256, 512) == 8
    assert cuda_norm.pack_vec(32, 4, 256, 8) == 1  # g unaligned
    assert cuda_norm.pack_vec(3, 2, 256, 512) == 1  # a row of 6 bytes
    plan = cuda_norm.plan_bwd(2, 50 * 70, 3, 4, 1, sms=_SMS, blocks_per_sm=2)
    assert plan.route == "one_launch" and plan.vec == 1
    assert plan.smem_bytes <= cuda_norm._SMEM_LIMIT
    wide = cuda_norm.plan_bwd(1, 64, 2048, 4, 4, sms=_SMS, blocks_per_sm=2)
    assert wide.route == "one_launch" and wide.smem_bytes <= cuda_norm._SMEM_LIMIT
    huge_row = cuda_norm.plan_bwd(1, 64, 16384, 4, 4, sms=_SMS, blocks_per_sm=2)
    assert huge_row.route == "two_launch"
    for kw in ({"one_launch": False}, {}):
        per_sm = 2 if kw else 0
        plan = cuda_norm.plan_bwd(8, 4096, 256, 2, 8, sms=_SMS, blocks_per_sm=per_sm, **kw)
        assert plan.route == "two_launch"


def _merge_slices(c, chunks):
    """The one-launch kernels' merge: block j takes channels [j * per,
    (j + 1) * per), per the least power of two with per * chunks >= c."""
    per = 1
    while per * chunks < c:
        per *= 2
    return [(j * per, min(c, (j + 1) * per)) for j in range(chunks) if j * per < c]


def _emulate_bwd_kernel(x, gy, mean, inv, gamma, beta, *, relu, itemsize, route):
    """numpy emulation (float32) of the CUDA backward's reduction, with the
    planner's chunks on a 132-SM card holding two one-launch blocks per SM.
    x, gy (n, h, w, c) already rounded to the working dtype. The gate and
    xhat as the plain version forms them (each operation rounded); then
    per chunk the gated sum(g) and sum(g * xhat): one launch, lane sums
    over the pixels (lane_sum) and each block's merge of its slice of the
    channels over the chunks (lane_sum again); two launches, 8 pixel lanes
    per 32-channel tile added in order, lane 0 adding the other 7, the same
    again over the chunks. dx = gamma * inv * (g - a - xhat * b), rounded
    to the working dtype; returns (dx, dgamma, dbeta)."""
    n, h, w, c = x.shape
    hw, f32 = h * w, np.float32
    xs = x.reshape(n, hw, c).astype(f32)
    gs = gy.reshape(n, hw, c).astype(f32)
    vec = cuda_norm.pack_vec(c, itemsize, 0, 0)
    plan = cuda_norm.plan_bwd(n, hw, c, itemsize, vec, sms=_SMS, blocks_per_sm=2,
                              one_launch=route == "one_launch")
    assert plan.route == route
    xh = (xs - mean[:, None]) * inv[:, None]
    gg = np.where(xh * gamma + beta > 0, gs, f32(0)) if relu else gs
    gx = gg * xh
    parts = []  # per chunk: (sum g, sum g * xhat), each (n, c)
    for j in range(plan.chunks):
        sl = slice(j * plan.chunk, (j + 1) * plan.chunk)
        if route == "one_launch":
            parts.append((_lane_sum(gg[:, sl], c // vec), _lane_sum(gx[:, sl], c // vec)))
        else:
            parts.append((_seq_lanes(gg[:, sl], 8), _seq_lanes(gx[:, sl], 8)))
    pa = np.stack([p[0] for p in parts], 1)  # (n, chunks, c)
    pb = np.stack([p[1] for p in parts], 1)
    if route == "one_launch":
        sg, sgx = np.zeros((n, c), f32), np.zeros((n, c), f32)
        for c0, c1 in _merge_slices(c, plan.chunks):
            sg[:, c0:c1] = _lane_sum(pa[:, :, c0:c1], c1 - c0)
            sgx[:, c0:c1] = _lane_sum(pb[:, :, c0:c1], c1 - c0)
    else:
        sg, sgx = _seq_lanes(pa, 8), _seq_lanes(pb, 8)
    a, b = sg / f32(hw), sgx / f32(hw)
    dx = (gamma * inv)[:, None] * (gg - a[:, None] - xh * b[:, None])
    dtype = torch.float32 if itemsize == 4 else torch.bfloat16
    dx = torch.from_numpy(dx.reshape(x.shape)).to(dtype).float().numpy()
    return dx, sgx, sg


def _seq_lanes(vals, lanes):
    """Sum over axis 1 as the two-launch backward adds: lane l takes rows
    l, l + lanes, ... in order, then lane 0 adds lanes 1, 2, ... in order."""
    sums = [vals[:, lane::lanes].cumsum(axis=1, dtype=np.float32)[:, -1]
            if lane < vals.shape[1] else np.zeros(vals.shape[:1] + vals.shape[2:], np.float32)
            for lane in range(lanes)]
    total = sums[0]
    for s_ in sums[1:]:
        total = total + s_
    return total


@pytest.mark.parametrize("route", ["one_launch", "two_launch"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape", _IN_SHAPES + [(2, 32, 32, 40), (1, 30, 35, 64)])
def test_in_bwd_kernel_reduction_emulation_matches_plain(shape, relu, dtype, route):
    """The backward kernels' chunked sums and their merges, emulated on the
    CPU, against the plain version on the same residuals and, at the
    shapes of the Pallas tests above, against _pallas_in_backward in
    interpret mode. f32: sums in another order, 1e-5; bf16: one ulp plus
    1e-2, as above."""
    x, gy, gamma, beta = _grad_inputs(shape, dtype, seed=19)
    itemsize = 4 if dtype == "float32" else 2
    tdt = getattr(torch, dtype)
    _, mean_t, inv_t = cuda_norm.instance_norm_fwd_reference(
        to_nchw(x, tdt), torch.from_numpy(gamma), torch.from_numpy(beta))
    mean, inv = mean_t.numpy(), inv_t.numpy()
    dx_e, dg_e, db_e = _emulate_bwd_kernel(x, gy, mean, inv, gamma, beta, relu=relu,
                                           itemsize=itemsize, route=route)
    dx_r, dg_r, db_r = cuda_norm.instance_norm_bwd_reference(
        to_nchw(x, tdt), to_nchw(gy, tdt), mean_t, inv_t, torch.from_numpy(gamma),
        torch.from_numpy(beta), relu=relu)
    np.testing.assert_allclose(dx_e, to_nhwc(dx_r), **_tol(dtype, 1e-5))
    np.testing.assert_allclose(dg_e, dg_r.numpy(), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(db_e, db_r.numpy(), rtol=1e-5, atol=1e-4)
    if shape in _IN_SHAPES:
        jdt = getattr(jnp, dtype)
        dx_j, dg_j, db_j = _pallas_in_backward(
            jnp.asarray(x).astype(jdt), jnp.asarray(gy).astype(jdt),
            jnp.asarray(mean[:, None]), jnp.asarray(inv[:, None]), jnp.asarray(gamma),
            jnp.asarray(beta), relu=relu, interpret=True)
        np.testing.assert_allclose(dx_e, np.asarray(dx_j, np.float32), **_tol(dtype, 1e-5))
        np.testing.assert_allclose(dg_e, np.asarray(dg_j)[:, 0], rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(db_e, np.asarray(db_j)[:, 0], rtol=1e-5, atol=1e-4)


def test_instance_norm_without_grad_makes_one_forward_call():
    """Under no_grad / inference_mode (the serving path) instance_norm is
    the plain forward call, not the autograd Function."""
    x, gamma, beta = _in_inputs((1, 4, 4, 8))
    xt = to_nchw(x).requires_grad_()
    with torch.no_grad():
        y = tnorm.instance_norm(xt, torch.from_numpy(gamma), torch.from_numpy(beta))
    assert y.grad_fn is None
    y = tnorm.instance_norm(xt, torch.from_numpy(gamma), torch.from_numpy(beta))
    assert type(y.grad_fn).__name__ == "InstanceNormFnBackward"


# conv backward: (1, 32, 128, 8) with a 3x3x3x8 W is inside the TPU
# kernel's gate; sums of 27 (dx: 9 taps x 8 channels = 72) or up to 4,096
# (dw) f32 products in other orders: 1e-4 relative to the largest output.


def _conv_inputs(n, h, w, ci, co, k, seed):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n, h, w, co)).astype(np.float32)
    x = rng.standard_normal((n, h, w, ci)).astype(np.float32)
    wt = (rng.standard_normal((k, k, ci, co)) * 0.2).astype(np.float32)  # HWIO
    b = rng.standard_normal(co).astype(np.float32)
    return g, x, wt, b


def _oihw(w_hwio: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))


def _close(got: np.ndarray, want: np.ndarray, rel: float = 1e-4):
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def test_conv_bwd_plain_matches_pallas_kernel_interpret():
    g, x, w, _ = _conv_inputs(1, 32, 128, 3, 8, 3, seed=13)
    assert pallas_conv.supported(g.shape, w.shape)
    dx_j, dw_j, db_j = pallas_conv.conv2d_same_bwd(
        jnp.asarray(g), jnp.asarray(x), jnp.asarray(w), interpret=True)
    dx_t, dw_t, db_t = cuda_conv.conv2d_same_bwd(to_nchw(g), to_nchw(x), _oihw(w))
    assert dx_t.is_contiguous(memory_format=torch.channels_last)
    assert dw_t.dtype == torch.float32 and dw_t.shape == (8, 3, 3, 3)
    _close(to_nhwc(dx_t), np.asarray(dx_j))
    _close(dw_t.numpy().transpose(2, 3, 1, 0), np.asarray(dw_j))
    _close(db_t.numpy(), np.asarray(db_j))
    dxo_j = pallas_conv.conv2d_same_dx(jnp.asarray(g), jnp.asarray(w), interpret=True)
    _close(to_nhwc(cuda_conv.conv2d_same_dx(to_nchw(g), _oihw(w))), np.asarray(dxo_j))


@pytest.mark.parametrize("need_w", [False, True])
def test_conv2d_same_small_cin_grad_matches_jax_vjp(need_w):
    """An odd shape the TPU kernel's gate refuses (13x21): the port's
    Function (cuDNN forward; dx-only or full backward, plain on the CPU)
    against jax.vjp of conv2d_same."""
    g, x, w, b = _conv_inputs(2, 13, 21, 3, 8, 3, seed=14)
    assert not pallas_conv.supported(g.shape, w.shape)
    y_j, vjp = jax.vjp(lambda a, w_, b_: jconv.conv2d_same(a, w_, b_),
                       jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    dx_j, dw_j, db_j = vjp(jnp.asarray(g))
    xt = to_nchw(x).requires_grad_()
    wt = _oihw(w).requires_grad_(need_w)
    bt = torch.from_numpy(b).requires_grad_(need_w)
    before = (cuda_conv.conv2d_same_dx.launches, cuda_conv.conv2d_same_bwd.launches)
    y_t = tconv.conv2d_same(xt, wt, bt, small_cin_kernel=True)
    assert type(y_t.grad_fn).__name__ == "Conv2dSameSmallCinFnBackward"
    _close(to_nhwc(y_t.detach()), np.asarray(y_j))
    grads = torch.autograd.grad(y_t, (xt, wt, bt) if need_w else (xt,), to_nchw(g))
    assert (cuda_conv.conv2d_same_dx.launches,
            cuda_conv.conv2d_same_bwd.launches) == before  # plain on the CPU
    _close(to_nhwc(grads[0]), np.asarray(dx_j))
    if need_w:
        _close(grads[1].numpy().transpose(2, 3, 1, 0), np.asarray(dw_j))
        _close(grads[2].numpy(), np.asarray(db_j))


def test_conv2d_same_matches_jax_forward():
    _, x, w, b = _conv_inputs(2, 9, 11, 16, 24, 3, seed=15)
    want = jconv.conv2d_same(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = tconv.conv2d_same(to_nchw(x), _oihw(w), torch.from_numpy(b))
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_max_pool_grad_after_relu_matches_jax():
    """PyTorch routes a 2x2 window's gradient to its first maximum, XLA's
    select-and-scatter maybe to another; after a ReLU the tied maxima are
    zeros whose gradient the ReLU zeroes, so dx agrees (odd sizes drop the
    last row and column, as VALID pooling does)."""
    rng = np.random.default_rng(16)
    x = rng.standard_normal((2, 9, 11, 8)).astype(np.float32) - 0.8  # many zeros
    gy = rng.standard_normal((2, 4, 5, 8)).astype(np.float32)
    f = lambda a: jconv.max_pool2d(jax.nn.relu(a))
    y_j, vjp = jax.vjp(f, jnp.asarray(x))
    (dx_j,) = vjp(jnp.asarray(gy))
    xt = to_nchw(x).requires_grad_()
    y_t = tconv.max_pool2d(torch.relu(xt))
    (dx_t,) = torch.autograd.grad(y_t, xt, to_nchw(gy))
    np.testing.assert_array_equal(to_nhwc(y_t.detach()), np.asarray(y_j))
    np.testing.assert_array_equal(to_nhwc(dx_t), np.asarray(dx_j))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gram_matrix_matches_jax(dtype):
    """f32 accumulation on both sides: a bf16 feature map gives an f32
    Gram (sums over 63 products in other orders: 1e-5 relative)."""
    f = np.random.default_rng(17).standard_normal((2, 7, 9, 16)).astype(np.float32)
    fj = jnp.asarray(f).astype(getattr(jnp, dtype))
    want = jgram.gram_matrix(fj)
    got = gram_matrix(torch.from_numpy(np.array(fj.astype(jnp.float32))).to(
        getattr(torch, dtype)))
    assert got.dtype == torch.float32 and got.shape == (2, 16, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)


# The conv kernel's staging and indexing, emulated in numpy step by step
# (tiles of 8 x 32 pixels, chunks of 32 output channels staged with a halo
# into [row][channel][column] buffers, groups of 4 input channels, the
# persistent grid of the full mode and its per-block dw/db rows), against
# the plain version: same products, another order of f32 sums (1e-4).

def _emulate_conv_kernel(g, x, w, full, max_blocks):
    """g (n, h, w, co), x (n, h, w, ci) numpy f32, w (co, ci, k, k)."""
    n, h, wd, co = g.shape
    ci, k = w.shape[1], w.shape[-1]
    p, kk, ci4 = k // 2, k * k, 4 * -(-ci // 4)
    th, tw, oc_chunk = cuda_conv._TILE_H, cuda_conv._TILE_W, 32
    rh, cw = th + 2 * p, tw + 2 * p
    gs_stride = cw | 1
    wpk = cuda_conv._pack(torch.from_numpy(w)).numpy()  # (co, kk, ci4)
    tiles_h, tiles_w = -(-h // th), -(-wd // tw)
    tiles = n * tiles_h * tiles_w
    blocks = min(tiles, max_blocks) if full else tiles
    entries = (kk * ci + 1) * co
    work = np.zeros((blocks, entries), np.float32)
    dx = np.zeros((n, h, wd, ci), np.float32)
    ty, tx = np.meshgrid(np.arange(th), np.arange(tw), indexing="ij")

    def stage(src, nb, h0, w0, chans):
        buf = np.zeros((rh, chans.size, gs_stride), np.float32)
        for row in range(rh):
            for col in range(cw):
                gh, gw = h0 - p + row, w0 - p + col
                if 0 <= gh < h and 0 <= gw < wd:
                    buf[row, :, col] = src[nb, gh, gw, chans]
        return buf

    for b in range(blocks):
        for tile in range(b, tiles, blocks):
            nb, rem = divmod(tile, tiles_h * tiles_w)
            h0, w0 = (rem // tiles_w) * th, (rem % tiles_w) * tw
            xs = stage(x, nb, h0, w0, np.arange(ci)) if full else None
            for grp in range(ci4 // 4):
                acc = np.zeros((th, tw, 4), np.float32)
                for o0 in range(0, co, oc_chunk):
                    occ = min(oc_chunk, co - o0)
                    gs = stage(g, nb, h0, w0, np.arange(o0, o0 + occ))
                    ws = wpk[o0:o0 + occ]
                    for oc in range(occ):
                        for u in range(k):
                            for v in range(k):
                                gv = gs[ty + 2 * p - u, oc, tx + 2 * p - v]
                                acc += gv[..., None] * ws[oc, u * k + v, 4 * grp:4 * grp + 4]
                    if full and grp == 0:
                        ginner = gs[p:p + th, :, p:p + tw]  # (th, occ, tw)
                        for r in range(kk * ci + 1):
                            if r < kk * ci:
                                uv, i = divmod(r, ci)
                                u, v = divmod(uv, k)
                                xv = xs[u:u + th, i, v:v + tw]  # (th, tw)
                                s = np.einsum("yx,yox->o", xv, ginner)
                            else:
                                s = ginner.sum(axis=(0, 2))
                            work[b, r * co + o0:r * co + o0 + occ] += s
                hh, ww = h0 + ty, w0 + tx
                keep = (hh < h) & (ww < wd)
                for j in range(4):
                    if 4 * grp + j < ci:
                        dx[nb, hh[keep], ww[keep], 4 * grp + j] = acc[..., j][keep]
    if not full:
        return dx
    dwb = work.sum(axis=0)
    dw = dwb[:kk * ci * co].reshape(k, k, ci, co).transpose(3, 2, 0, 1)
    return dx, dw, dwb[kk * ci * co:]


@pytest.mark.parametrize("n,h,w,ci,co,k", [
    (1, 10, 40, 3, 8, 3),    # ragged tiles on both edges
    (2, 9, 33, 1, 40, 5),    # two output-channel chunks, the second short
    (1, 8, 32, 5, 6, 1),     # two input-channel groups, k = 1
])
def test_conv_kernel_tiling_emulation_matches_plain(n, h, w, ci, co, k):
    g, x, _, _ = _conv_inputs(n, h, w, ci, co, k, seed=18)
    wt = (np.random.default_rng(19).standard_normal((co, ci, k, k)) * 0.2).astype(np.float32)
    dx_r, dw_r, db_r = cuda_conv.conv2d_same_bwd_reference(
        to_nchw(g), to_nchw(x), torch.from_numpy(wt))
    dx_e = _emulate_conv_kernel(g, x, wt, full=False, max_blocks=0)
    _close(dx_e, to_nhwc(dx_r))
    dx_f, dw_f, db_f = _emulate_conv_kernel(g, x, wt, full=True, max_blocks=3)
    _close(dx_f, to_nhwc(dx_r))
    _close(dw_f, dw_r.numpy())
    _close(db_f, db_r.numpy())


def test_conv_kernel_gate():
    assert cuda_conv.supported(3, 3) and cuda_conv.supported(9, 1)
    assert cuda_conv.supported(1, 128) and cuda_conv.supported(11, 1)
    assert not cuda_conv.supported(2, 3)  # even k
    assert not cuda_conv.supported(3, 15)  # 135 > 128
    assert not cuda_conv.supported(13, 1)
    assert not cuda_conv.supported(3, 3, stride=2)


# The tap-packed dx kernel (route "tap_packed"): its planner, and its
# strips, pieces, row loop, P ring and halo zero-fill emulated in numpy.


def _tp_blocks_per_sm(dtype):
    return 4 if dtype == torch.bfloat16 else 2


def _tp_pieces(n, h, w, blocks):
    """Per block of a tap-packed launch, its pieces (sample, first output
    column, first row, end row), as the kernel walks them (plan_conv_dx's
    docstring)."""
    strips = -(-w // 64)
    total = n * strips * h
    out = []
    for b in range(blocks):
        idx, end = total * b // blocks, total * (b + 1) // blocks
        pieces = []
        while idx < end:
            col, ra = divmod(idx, h)
            rb = min(h, ra + end - idx)
            idx += rb - ra
            nb, strip = divmod(col, strips)
            pieces.append((nb, strip * 64, ra, rb))
        out.append(pieces)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("hw", [(256, 256), (200, 300)])
@pytest.mark.parametrize("n", [1, 8, 20])
def test_plan_conv_dx_takes_tap_packed_for_conv1_1(n, hw, dtype):
    """VGG conv1_1 (k3, 3 <- 64) at the training and check shapes: the
    tap-packed route, two or more blocks an SM (shared memory <= 113 KB),
    one wave of the card's slots, and pieces that cover every output pixel
    once, each block within one row of the others."""
    h, w = hw
    plan = cuda_conv.plan_conv_dx(n, h, w, 3, 64, 3, dtype, True)
    assert plan.route == "tap_packed" and plan.strip == 64 and plan.stages == 4
    assert plan.smem_bytes <= min(cuda_conv._SMEM_LIMIT, 113 * 1024)
    segments = n * -(-w // 64) * h
    assert plan.blocks == min(segments, 132 * _tp_blocks_per_sm(dtype))
    seen = np.zeros((n, h, w), np.int32)
    rows = []
    for pieces in _tp_pieces(n, h, w, plan.blocks):
        rows.append(sum(rb - ra for _, _, ra, rb in pieces))
        for nb, c0, ra, rb in pieces:
            assert 0 <= ra < rb <= h and c0 % 64 == 0 and c0 < w
            seen[nb, ra:rb, c0:c0 + 64] += 1
    assert (seen == 1).all()
    assert max(rows) - min(rows) <= 1 and max(rows) == plan.rows


@pytest.mark.parametrize("change", [
    dict(k=9, c_in=1),  # k*k*C_in = 81 > 32
    dict(k=3, c_in=4),  # 36 > 32
    dict(k=7, c_in=1),  # 49 > 32
    dict(k=1, c_in=3),  # k = 1: no halo, the tiled kernel serves it
    dict(c_out=48),  # not the kernel's C_out
    dict(c_out=128),
    dict(aligned=False),  # g off the 16-byte grid
    dict(w_same_dtype=False),  # w in another dtype than g
], ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()))
def test_plan_conv_dx_sends_other_shapes_to_tiled(change):
    """Shapes inside the gate that the tap-packed kernel does not take run
    on the tiled kernel: one block per 8 x 32 tile."""
    args = dict(n=2, h=37, w=70, c_in=3, c_out=64, k=3, dtype=torch.float32,
                aligned=True)
    args.update(change)
    same = args.pop("w_same_dtype", True)
    assert cuda_conv.supported(args["k"], args["c_in"])
    plan = cuda_conv.plan_conv_dx(**args, w_same_dtype=same)
    assert plan.route == "tiled" and plan.stages == 0
    assert plan.blocks == 2 * 5 * 3
    assert plan.smem_bytes == cuda_conv.tiled_smem_bytes(args["k"], args["c_in"])


def test_plan_conv_dx_grid_follows_the_card():
    """The grid is the card's slots (SMs x blocks an SM holds), and never
    more blocks than row segments."""
    plan = cuda_conv.plan_conv_dx(20, 256, 256, 3, 64, 3, torch.bfloat16, True,
                                  sms=100, blocks_per_sm=3)
    assert plan.blocks == 300 and plan.rows == -(-20 * 4 * 256 // 300)
    tiny = cuda_conv.plan_conv_dx(1, 2, 10, 3, 64, 3, torch.float32, True)
    assert tiny.blocks == 2 and tiny.rows == 1
    for ci, k in ((1, 3), (2, 3), (3, 3), (1, 5)):  # the kernel's (C_in, k)
        assert cuda_conv.plan_conv_dx(1, 8, 8, ci, 64, k, torch.float32,
                                      True).route == "tap_packed"


def _emulate_tap_packed(g, w, blocks):
    """The tap-packed kernel step by step: g (n, h, w, 64) f32, w (64, ci,
    k, k) -> dx (n, h, w, ci). Each block walks its pieces; a piece loads
    its g rows (64 + 2p columns, zeros outside the image) one at a time,
    multiplies each by W' (64 x 32) into a ring of k P rows in f32, and
    emits dx row r once P rows r - p .. r + p are in the ring."""
    n, h, wd, co = g.shape
    ci, k = w.shape[1], w.shape[-1]
    p, kkc, strip = k // 2, k * k * ci, cuda_conv._TP_STRIP
    qc = strip + 2 * p
    wprime = np.zeros((co, cuda_conv._TP_COLS), np.float32)
    wprime[:, :kkc] = w.transpose(0, 2, 3, 1).reshape(co, kkc)  # [o, (u, v, i)]
    dx = np.full((n, h, wd, ci), np.nan, np.float32)
    px = np.arange(strip)
    for pieces in _tp_pieces(n, h, wd, blocks):
        for nb, c0, ra, rb in pieces:
            cols = min(strip, wd - c0)
            ring = np.zeros((k, qc, kkc), np.float32)
            for t in range(rb - ra + 2 * p):
                gr, lo = ra - p + t, c0 - p
                seg = np.zeros((qc, co), np.float32)
                if 0 <= gr < h:
                    a, b = max(lo, 0), min(lo + qc, wd)
                    seg[a - lo:b - lo] = g[nb, gr, a:b]
                ring[t % k] = (seg @ wprime)[:, :kkc]
                if t < 2 * p:
                    continue
                s = np.zeros((strip, ci), np.float32)
                for u in range(k):
                    for v in range(k):
                        j = (u * k + v) * ci
                        s += ring[(t - u) % k][px + 2 * p - v, j:j + ci]
                r = ra + t - 2 * p
                assert np.isnan(dx[nb, r, c0:c0 + cols]).all()  # written once
                dx[nb, r, c0:c0 + cols] = s[:cols]
    assert not np.isnan(dx).any()
    return dx


def test_tap_packed_emulation_matches_pallas_kernel_interpret():
    """Inside the TPU kernel's gate (H % 16, W % 128), VGG conv1_1's shape
    class: the emulation against the plain version and the Pallas kernel
    (interpret mode)."""
    g, _, w, _ = _conv_inputs(1, 32, 128, 3, 64, 3, seed=20)
    assert pallas_conv.supported(g.shape, w.shape)
    want = np.asarray(pallas_conv.conv2d_same_dx(jnp.asarray(g), jnp.asarray(w),
                                                 interpret=True))
    plan = cuda_conv.plan_conv_dx(1, 32, 128, 3, 64, 3, torch.float32, True,
                                  sms=4, blocks_per_sm=2)
    got = _emulate_tap_packed(g, _oihw(w).numpy(), plan.blocks)
    _close(got, want)
    _close(to_nhwc(cuda_conv.conv2d_same_dx_reference(to_nchw(g), _oihw(w))), want)


@pytest.mark.parametrize("n,h,w,ci,k,blocks", [
    (2, 13, 150, 3, 3, 7),  # ragged last strip; ranges cross strips and images
    (1, 9, 70, 1, 5, 4),    # k = 5: two halo rows and columns
    (1, 6, 40, 2, 3, 3),    # C_in = 2, one short strip
])
def test_tap_packed_emulation_matches_plain(n, h, w, ci, k, blocks):
    g, _, _, _ = _conv_inputs(n, h, w, ci, 64, k, seed=21)
    wt = (np.random.default_rng(22).standard_normal((64, ci, k, k)) * 0.2).astype(np.float32)
    want = to_nhwc(cuda_conv.conv2d_same_dx_reference(to_nchw(g), torch.from_numpy(wt)))
    _close(_emulate_tap_packed(g, wt, blocks), want)


# -- slice 7: per-sample (N, C) affines (conditional instance norm) -----------
#
# Multi-style training conditions each example on its own style, so every IN
# site gets an (N, C) affine. The JAX package sends that shape to XLA
# (``instance_norm(method="xla")``, or "onepass"); the port's plain versions
# must agree with it, and its backward must return dgamma / dbeta per sample
# (summing them over the batch would give a wrong style-bank gradient). Rows
# differ and hold negative entries, so the ReLU gate flips per sample.
# f32; sums in other orders: 1e-5 of the largest value.


def _rows(n, c, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, c)).astype(np.float32),
            rng.standard_normal((n, c)).astype(np.float32))


def _close_rel(got, want, rel=1e-5):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * np.abs(want).max())


@pytest.mark.parametrize("onepass", [False, True])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape", _IN_SHAPES + [(3, 6, 5, 40)])
def test_per_sample_affine_matches_jax_vjp(shape, relu, onepass):
    """instance_norm with (N, C) gamma / beta, forward and autograd, against
    jax.vjp of the JAX package's instance_norm (method "xla", or "onepass"
    for the one-pass statistics): y, dx and the per-sample dgamma, dbeta."""
    x, _, _ = _in_inputs(shape, seed=21)
    gamma, beta = _rows(shape[0], shape[-1], seed=22)
    gy = np.random.default_rng(23).standard_normal(shape).astype(np.float32)
    method = "onepass" if onepass else "xla"
    y_j, vjp = jax.vjp(
        lambda a, g_, b_: jnorm.instance_norm(a, g_, b_, relu=relu, method=method),
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    dx_j, dg_j, db_j = vjp(jnp.asarray(gy))
    xt = to_nchw(x).requires_grad_()
    gt = torch.from_numpy(gamma).requires_grad_()
    bt = torch.from_numpy(beta).requires_grad_()
    y_t = tnorm.instance_norm(xt, gt, bt, relu=relu, onepass=onepass)
    dx_t, dg_t, db_t = torch.autograd.grad(y_t, (xt, gt, bt), to_nchw(gy))
    assert dg_t.shape == db_t.shape == (shape[0], shape[-1])
    _close_rel(to_nhwc(y_t.detach()), y_j)
    _close_rel(to_nhwc(dx_t), dx_j)
    _close_rel(dg_t.numpy(), dg_j)
    _close_rel(db_t.numpy(), db_j)


@pytest.mark.parametrize("relu", [False, True])
def test_per_sample_rows_are_per_sample_calls(relu):
    """The plain versions with an (N, C) affine equal, bit for bit, one call
    per sample with its (C,) row; an (N, C) affine of equal rows equals the
    (C,) call bit for bit (what chip_smoke.py holds the kernels to)."""
    x, gamma, beta = _in_inputs((3, 5, 7, 16), seed=24)
    g_rows, b_rows = _rows(3, 16, seed=25)
    gy = to_nchw(np.random.default_rng(26).standard_normal(x.shape).astype(np.float32))
    xt = to_nchw(x)
    y, mean, inv = cuda_norm.instance_norm_fwd_reference(
        xt, torch.from_numpy(g_rows), torch.from_numpy(b_rows), relu=relu)
    grads = cuda_norm.instance_norm_bwd_reference(
        xt, gy, mean, inv, torch.from_numpy(g_rows), torch.from_numpy(b_rows), relu=relu)
    for s in range(3):
        one = cuda_norm.instance_norm_fwd_reference(
            xt[s:s + 1], torch.from_numpy(g_rows[s]), torch.from_numpy(b_rows[s]), relu=relu)
        assert torch.equal(one[0], y[s:s + 1]) and torch.equal(one[2], inv[s:s + 1])
        one_b = cuda_norm.instance_norm_bwd_reference(
            xt[s:s + 1], gy[s:s + 1], mean[s:s + 1], inv[s:s + 1],
            torch.from_numpy(g_rows[s]), torch.from_numpy(b_rows[s]), relu=relu)
        for a, b in zip(one_b, grads):
            assert torch.equal(a, b[s:s + 1])
    same_g = torch.from_numpy(np.tile(gamma, (3, 1)))
    same_b = torch.from_numpy(np.tile(beta, (3, 1)))
    per_row = cuda_norm.instance_norm_fwd_reference(xt, same_g, same_b, relu=relu)
    per_ch = cuda_norm.instance_norm_fwd_reference(
        xt, torch.from_numpy(gamma), torch.from_numpy(beta), relu=relu)
    assert all(torch.equal(a, b) for a, b in zip(per_row, per_ch))


def test_check_takes_channel_and_sample_affines():
    x = to_nchw(np.zeros((2, 3, 3, 8), np.float32))
    for shape in ((8,), (2, 8)):
        cuda_norm._check(x, torch.ones(shape), torch.zeros(shape))
    for shape in ((3, 8), (8, 1), (2, 8, 1), (7,)):
        with pytest.raises(ValueError, match="neither"):
            cuda_norm._check(x, torch.ones(shape), torch.zeros(8))
        with pytest.raises(ValueError, match="neither"):
            cuda_norm._check(x, torch.ones(8), torch.zeros(shape))
    # the kernels' row stride: 0 for one (C,) row, C for (N, C) rows
    assert cuda_norm._affine_rows(torch.ones(8), torch.ones(8), 8)[2] == 0
    assert cuda_norm._affine_rows(torch.ones(2, 8), torch.ones(2, 8), 8)[2] == 8


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("hwc", _SITE_HWC)
def test_plans_ignore_the_affine_and_take_one_launch(hwc, dtype, monkeypatch):
    """The planners see shapes only, so both affine kinds take the same
    plan; at the training batch of 20 every 256^2 site takes the one-launch
    forward (stable and one-pass statistics) and backward, on a 132-SM card
    holding two blocks of each per SM (meta tensors stand in for the
    card's)."""
    import inspect

    for fn in (cuda_norm.plan_fwd, cuda_norm.plan_bwd, cuda_norm.fwd_plan,
               cuda_norm.bwd_plan):
        assert not {"gamma", "beta"} & set(inspect.signature(fn).parameters)
    monkeypatch.setattr(cuda_norm, "_capacity", lambda *a: (2, _SMS))
    h, w, c = hwc
    x = torch.empty((20, c, h, w), dtype=dtype, device="meta").contiguous(
        memory_format=torch.channels_last)
    for onepass in (False, True):
        assert cuda_norm.fwd_plan(x, onepass=onepass).route == "one_launch"
    assert cuda_norm.bwd_plan(x, x).route == "one_launch"
