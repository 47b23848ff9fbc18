"""Backward of a stride-1 SAME conv with few input channels on the card: the
wrapper of ``csrc/conv_same_bwd.cu``, its plain PyTorch versions, and the
autograd Function that puts it under VGG ``conv1_1``.

Replaces the TPU kernel ``fast_neural_style_transfer_tpu/ops/pallas_conv.py::
_bwd_kernel`` (``conv2d_same_bwd``, ``conv2d_same_dx``). The kernel is bound
by bytes (read the 64-channel gradient once, write the 3-channel dx once);
the source file states the bound, the layout and the design.

Tensors are PyTorch's: g (N, C_out, H, W) and x, dx (N, C_in, H, W) in
``torch.channels_last`` memory format (physically NHWC), w (C_out, C_in, k,
k). dw and db come back float32. The gate is the kernel's own: odd k <= 11,
stride 1, k*k*C_in <= 128, any H and W (the TPU's H % 16 and W % 128 came
from its tiling). On a CUDA tensor a shape outside the gate raises; it never
goes quietly to cuDNN.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from fast_neural_style_transfer_tpu_torch.ops import _build

_TILE_H, _TILE_W = 8, 32  # kTH, kTW in the source
_MAX_FULL_BLOCKS = 4 * 132  # persistent grid of the full mode: 4 per SM
_SMEM_LIMIT = 232_448  # bytes of shared memory one Hopper block may use

_fns = None


def _kernel():
    global _fns
    if _fns is None:
        lib = _build.load("conv_same_bwd")
        fn = lib.fnst_conv_same_bwd
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        smem = lib.fnst_conv_same_bwd_smem
        smem.argtypes = [ctypes.c_int] * 3
        smem.restype = ctypes.c_longlong
        _fns = (fn, smem)
    return _fns


def supported(k: int, c_in: int, stride: int = 1) -> bool:
    """The kernel's gate."""
    return stride == 1 and k % 2 == 1 and k <= 11 and k * k * c_in <= 128


# -- plain versions ------------------------------------------------------------


def conv2d_same_dx_reference(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dx as k*k shifted products in f32: dx[h, w] = sum_{u,v}
    g[h+p-u, w+p-v] @ w[:, :, u, v]. Returns g's dtype, channels_last."""
    k = w.shape[-1]
    p = k // 2
    gf = g.float().permute(0, 2, 3, 1)  # NHWC view
    n, h, wd, _ = gf.shape
    gp = F.pad(gf, (0, 0, p, p, p, p))
    wf = w.float()
    dx = None
    for u in range(k):
        for v in range(k):
            term = gp[:, 2 * p - u:2 * p - u + h, 2 * p - v:2 * p - v + wd, :] @ wf[:, :, u, v]
            dx = term if dx is None else dx + term
    return dx.permute(0, 3, 1, 2).to(g.dtype).contiguous(memory_format=torch.channels_last)


def conv2d_same_bwd_reference(
    g: torch.Tensor, x: torch.Tensor, w: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dw, db) in f32 arithmetic: dx as ``conv2d_same_dx_reference``,
    dw[o, i, u, v] = sum x[h+u-p, w+v-p, i] g[h, w, o], db = sum g."""
    k = w.shape[-1]
    p = k // 2
    dx = conv2d_same_dx_reference(g, w)
    gf = g.float().permute(0, 2, 3, 1)
    xf = x.float().permute(0, 2, 3, 1)
    n, h, wd, _ = gf.shape
    xp = F.pad(xf, (0, 0, p, p, p, p))
    dw = torch.empty(w.shape, dtype=torch.float32, device=g.device)
    for u in range(k):
        for v in range(k):
            dw[:, :, u, v] = torch.einsum(
                "nhwi,nhwo->oi", xp[:, u:u + h, v:v + wd, :], gf)
    return dx, dw, gf.sum(dim=(0, 1, 2))


# -- kernel wrappers ------------------------------------------------------------


def _check(g: torch.Tensor, w: torch.Tensor, x: Optional[torch.Tensor]) -> None:
    if g.dim() != 4 or w.dim() != 4:
        raise ValueError(f"want g (N, C_out, H, W) and w (C_out, C_in, k, k); "
                         f"got {tuple(g.shape)} and {tuple(w.shape)}")
    co, ci, k, k2 = w.shape
    if g.shape[1] != co:
        raise ValueError(f"g has {g.shape[1]} channels, w {co} outputs")
    if k != k2 or not supported(k, ci):
        raise ValueError(
            f"conv backward kernel gate: odd k <= 11, stride 1, k*k*C_in <= "
            f"128; got k={k}x{k2}, C_in={ci}")
    if g.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"conv backward kernel takes float32 or bfloat16, got {g.dtype}")
    if not g.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("conv backward kernel wants a channels_last contiguous g")
    if g.numel() == 0:
        raise ValueError(f"conv backward kernel got an empty g {tuple(g.shape)}")
    if w.device != g.device:
        raise ValueError(f"w is on {w.device}, g on {g.device}")
    if x is not None:
        if x.shape != (g.shape[0], ci, g.shape[2], g.shape[3]) or x.dtype != g.dtype:
            raise ValueError(f"x {tuple(x.shape)} {x.dtype} does not match g and w")
        if not x.is_contiguous(memory_format=torch.channels_last):
            raise ValueError("conv backward kernel wants a channels_last contiguous x")


def _pack(w: torch.Tensor) -> torch.Tensor:
    """(C_out, C_in, k, k) -> (C_out, k*k, ci4) f32, zero-padded inputs."""
    co, ci, k, _ = w.shape
    ci4 = 4 * -(-ci // 4)
    wp = w.detach().float().permute(0, 2, 3, 1).reshape(co, k * k, ci)
    return F.pad(wp, (0, ci4 - ci)).contiguous()


def _launch(g, x, w, full):
    n, co, h, wd = g.shape
    ci, k = w.shape[1], w.shape[-1]
    fn, smem = _kernel()
    if smem(k, ci, int(full)) > _SMEM_LIMIT:
        raise ValueError(f"conv backward kernel: k={k}, C_in={ci} needs more "
                         "shared memory than a block has")
    tiles = n * -(-h // _TILE_H) * -(-wd // _TILE_W)
    blocks = min(tiles, _MAX_FULL_BLOCKS) if full else tiles
    dx = torch.empty((n, ci, h, wd), dtype=g.dtype, device=g.device,
                     memory_format=torch.channels_last)
    entries = (k * k * ci + 1) * co
    if full:
        work = torch.zeros((blocks, entries), dtype=torch.float32, device=g.device)
        dwb = torch.empty(entries, dtype=torch.float32, device=g.device)
    else:
        work = dwb = None
    wpk = _pack(w)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    err = fn(g.data_ptr(), x.data_ptr() if full else 0, wpk.data_ptr(),
             dx.data_ptr(), work.data_ptr() if full else 0,
             dwb.data_ptr() if full else 0, n, h, wd, ci, co, k, int(full),
             blocks, int(g.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"conv backward kernel launch failed: CUDA error {err}")
    if not full:
        return dx
    dw = dwb[:k * k * ci * co].view(k, k, ci, co).permute(3, 2, 0, 1).contiguous()
    return dx, dw, dwb[k * k * ci * co:]


def _device_ok(t: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {t.device}")
    return True


def conv2d_same_dx(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dx of ``conv2d_same(x, w, b)``: channels_last, in g's dtype.

    A CPU tensor takes the plain version. A CUDA tensor launches the kernel
    or raises: a shape outside the gate, a wrong dtype or layout, a failed
    build or a failed launch."""
    if not _device_ok(g, "conv2d_same_dx"):
        return conv2d_same_dx_reference(g, w)
    _check(g, w, None)
    dx = _launch(g, None, w, full=False)
    conv2d_same_dx.launches += 1
    return dx


def conv2d_same_bwd(
    g: torch.Tensor, x: torch.Tensor, w: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx in g's dtype, dw f32 (C_out, C_in, k, k), db f32 (C_out,)) of
    ``conv2d_same(x, w, b)``; the CPU and CUDA rules of ``conv2d_same_dx``."""
    if not _device_ok(g, "conv2d_same_bwd"):
        return conv2d_same_bwd_reference(g, x, w)
    _check(g, w, x)
    out = _launch(g, x, w, full=True)
    conv2d_same_bwd.launches += 1
    return out


conv2d_same_dx.launches = 0
conv2d_same_bwd.launches = 0


class Conv2dSameSmallCinFn(torch.autograd.Function):
    """``conv2d_same`` whose forward is cuDNN (``F.conv2d(padding=k//2)``)
    and whose backward is the kernel: dx-only when neither w nor b needs a
    gradient (the frozen VGG of the training path), the full kernel when one
    does. w and b arrive already cast to x's dtype."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        return F.conv2d(x, w, b, padding=w.shape[-1] // 2)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        g = gy.contiguous(memory_format=torch.channels_last)
        if not (ctx.needs_input_grad[1] or ctx.needs_input_grad[2]):
            return conv2d_same_dx(g, w), None, None
        dx, dw, db = conv2d_same_bwd(
            g, x.contiguous(memory_format=torch.channels_last), w)
        return (dx, dw.to(w.dtype) if ctx.needs_input_grad[1] else None,
                db.to(w.dtype) if ctx.needs_input_grad[2] else None)
