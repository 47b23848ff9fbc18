"""Instance norm on the card: the wrappers of ``csrc/instance_norm.cu``
(forward and backward), their plain PyTorch versions, and the autograd
Function that joins them.

Replaces the TPU kernels ``fast_neural_style_transfer_tpu/ops/pallas_norm.py::
_in_fwd_kernel`` and ``_in_bwd_kernel``. Both kernels are bound by bytes
(forward: read x, write y; backward: read x and g, write dx); the source
file states the bounds and the two-launch design that splits H*W across
blocks, so that every IN site of the stylizer runs on the kernels at every
batch size, with no size gate and no fallback.

Activations are NCHW tensors in ``torch.channels_last`` memory format, i.e.
physically NHWC, the layout the TPU kernels saw. ``mean`` and ``inv`` come
back as (N, C) float32, and so do the per-sample ``dgamma`` and ``dbeta``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from fast_neural_style_transfer_tpu_torch.ops import _build

_TILE_C = 32  # channels per block (kTileC in the source)
_MIN_CHUNK = 256  # fewest pixels a block reduces
_MAX_CHUNKS = 64  # most chunk partials each apply block re-reads
_TARGET_BLOCKS = 4 * 132  # about four blocks on each of the H100's 132 SMs

_fns = None


def _kernels():
    """(forward, backward) entry points of the built library."""
    global _fns
    if _fns is None:
        lib = _build.load("instance_norm")
        fwd = lib.fnst_instance_norm_fwd
        fwd.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                        + [ctypes.c_float] + [ctypes.c_int] * 3
                        + [ctypes.c_void_p])
        fwd.restype = ctypes.c_int
        bwd = lib.fnst_instance_norm_bwd
        bwd.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                        + [ctypes.c_void_p])
        bwd.restype = ctypes.c_int
        _fns = (fwd, bwd)
    return _fns


def _moments(xf: torch.Tensor, onepass: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 (mean, biased var) over H, W of an (N, C, H, W) tensor."""
    mean = xf.mean(dim=(2, 3))
    if onepass:
        var = torch.clamp(xf.square().mean(dim=(2, 3)) - mean.square(), min=0.0)
    else:
        var = (xf - mean[:, :, None, None]).square().mean(dim=(2, 3))
    return mean, var


def instance_norm_fwd_reference(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    *,
    eps: float = 1e-5,
    relu: bool = False,
    onepass: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: same outputs, f32 statistics.
    ``onepass`` selects var = max(E[x^2] - mean^2, 0) (the TPU kernel's
    arithmetic) over the two-pass variance around the mean."""
    xf = x.float()
    mean, var = _moments(xf, onepass)
    inv = torch.rsqrt(var + eps)
    scale = inv * gamma.float()
    shift = beta.float() - mean * scale
    y = xf * scale[:, :, None, None] + shift[:, :, None, None]
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype), mean, inv


def _num_chunks(n: int, hw: int, tiles: int) -> int:
    """Pixel chunks per (sample, channel tile): enough blocks to fill the
    card, at least _MIN_CHUNK pixels each, at most _MAX_CHUNKS."""
    want = -(-_TARGET_BLOCKS // (n * tiles))
    return max(1, min(want, _MAX_CHUNKS, hw // _MIN_CHUNK))


def _check(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor) -> None:
    if x.dim() != 4:
        raise ValueError(f"the IN kernels want (N, C, H, W), got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the IN kernels take float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("the IN kernels want a channels_last contiguous x")
    n, c, h, w = x.shape
    if n * h * w == 0 or c == 0:
        raise ValueError(f"the IN kernels got an empty tensor {tuple(x.shape)}")
    for name, p in (("gamma", gamma), ("beta", beta)):
        if p.shape != (c,):
            raise ValueError(f"{name} shape {tuple(p.shape)} != ({c},)")
        if p.device != x.device:
            raise ValueError(f"{name} is on {p.device}, x on {x.device}")


def instance_norm_fwd(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    *,
    eps: float = 1e-5,
    relu: bool = False,
    onepass: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Instance norm + affine (+ReLU) -> (y, mean, inv).

    A CPU tensor takes the plain version. A CUDA tensor launches the kernel
    or raises: wrong dtype or layout, a failed build or a failed launch.
    Gradients go through ``InstanceNormFn``."""
    if x.device.type == "cpu":
        return instance_norm_fwd_reference(
            x, gamma, beta, eps=eps, relu=relu, onepass=onepass)
    if x.device.type != "cuda":
        raise ValueError(f"instance_norm_fwd runs on cuda or cpu, not {x.device}")
    _check(x, gamma, beta)
    n, c, h, w = x.shape
    hw = h * w
    tiles = -(-c // _TILE_C)
    chunk = -(-hw // _num_chunks(n, hw, tiles))
    chunks = -(-hw // chunk)
    y = torch.empty_like(x, memory_format=torch.channels_last)
    mean = torch.empty((n, c), dtype=torch.float32, device=x.device)
    inv = torch.empty_like(mean)
    work = torch.empty((3, n, chunks, c), dtype=torch.float32, device=x.device)
    g = gamma.detach().to(torch.float32).contiguous()
    b = beta.detach().to(torch.float32).contiguous()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _kernels()[0](
        x.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(),
        mean.data_ptr(), inv.data_ptr(), work.data_ptr(),
        n, hw, c, chunk, chunks, float(eps), int(relu), int(onepass),
        int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"instance-norm kernel launch failed: CUDA error {err}")
    instance_norm_fwd.launches += 1
    return y, mean, inv


instance_norm_fwd.launches = 0


def instance_norm_bwd_reference(
    x: torch.Tensor,
    g: torch.Tensor,
    mean: torch.Tensor,
    inv: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    *,
    relu: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernel, the TPU kernel's
    formula: xhat = (x - mean) * inv; with ``relu`` the gradient is gated by
    xhat * gamma + beta > 0 in f32 (not by y); dx = gamma * inv * (g -
    mean(g) - xhat * mean(g * xhat)). Returns (dx in x's dtype, per-sample
    dgamma (N, C) f32, per-sample dbeta (N, C) f32)."""
    hw = x.shape[2] * x.shape[3]
    col = lambda t: t.float()[:, :, None, None]
    xhat = (x.float() - col(mean)) * col(inv)
    gf = g.float()
    gam = gamma.float()[None, :, None, None]
    if relu:
        gf = torch.where(xhat * gam + beta.float()[None, :, None, None] > 0,
                         gf, torch.zeros((), device=gf.device))
    g_sum = gf.sum(dim=(2, 3))
    gx_sum = (gf * xhat).sum(dim=(2, 3))
    dx = (gam * col(inv)) * (gf - col(g_sum) / hw - xhat * (col(gx_sum) / hw))
    return dx.to(x.dtype), gx_sum, g_sum


def instance_norm_bwd(
    x: torch.Tensor,
    g: torch.Tensor,
    mean: torch.Tensor,
    inv: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    *,
    relu: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """IN (+ReLU) backward -> (dx, dgamma (N, C) f32, dbeta (N, C) f32);
    g must already be in x's dtype and layout.

    A CPU tensor takes the plain version. A CUDA tensor launches the kernel
    or raises: wrong dtype or layout, a failed build or a failed launch."""
    if x.device.type == "cpu":
        return instance_norm_bwd_reference(x, g, mean, inv, gamma, beta, relu=relu)
    if x.device.type != "cuda":
        raise ValueError(f"instance_norm_bwd runs on cuda or cpu, not {x.device}")
    _check(x, gamma, beta)
    n, c, h, w = x.shape
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"g {tuple(g.shape)} {g.dtype} does not match x "
                         f"{tuple(x.shape)} {x.dtype}")
    if not g.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("instance_norm_bwd wants a channels_last contiguous g")
    for name, r in (("mean", mean), ("inv", inv)):
        if r.shape != (n, c) or r.dtype != torch.float32 or not r.is_contiguous():
            raise ValueError(f"{name} must be a contiguous ({n}, {c}) float32 tensor")
    hw = h * w
    tiles = -(-c // _TILE_C)
    chunk = -(-hw // _num_chunks(n, hw, tiles))
    chunks = -(-hw // chunk)
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    dgamma = torch.empty((n, c), dtype=torch.float32, device=x.device)
    dbeta = torch.empty_like(dgamma)
    work = torch.empty((2, n, chunks, c), dtype=torch.float32, device=x.device)
    gm = gamma.detach().to(torch.float32).contiguous()
    bt = beta.detach().to(torch.float32).contiguous()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _kernels()[1](
        x.data_ptr(), g.data_ptr(), mean.data_ptr(), inv.data_ptr(),
        gm.data_ptr(), bt.data_ptr(), dx.data_ptr(), dgamma.data_ptr(),
        dbeta.data_ptr(), work.data_ptr(), n, hw, c, chunk, chunks,
        int(relu), int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(
            f"instance-norm backward kernel launch failed: CUDA error {err}")
    instance_norm_bwd.launches += 1
    return dx, dgamma, dbeta


instance_norm_bwd.launches = 0


class InstanceNormFn(torch.autograd.Function):
    """IN + affine (+ReLU) under autograd: forward ``instance_norm_fwd``
    (saving the input x, gamma, beta and the (mean, inv) residuals, never
    y), backward ``instance_norm_bwd`` with the upstream gradient cast to
    x's dtype and made channels_last first, and dgamma / dbeta summed over
    the batch."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, relu):
        y, mean, inv = instance_norm_fwd(x, gamma, beta, eps=eps, relu=relu)
        ctx.save_for_backward(x, gamma, beta, mean, inv)
        ctx.relu = relu
        return y

    @staticmethod
    def backward(ctx, gy):
        x, gamma, beta, mean, inv = ctx.saved_tensors
        g = gy.to(x.dtype).contiguous(memory_format=torch.channels_last)
        dx, dgn, dbn = instance_norm_bwd(x, g, mean, inv, gamma, beta,
                                         relu=ctx.relu)
        return (dx, dgn.sum(dim=0).to(gamma.dtype),
                dbn.sum(dim=0).to(beta.dtype), None, None)
