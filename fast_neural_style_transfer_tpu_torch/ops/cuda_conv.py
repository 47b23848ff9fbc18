"""Backward of a stride-1 SAME conv with few input channels on the card: the
wrapper of ``csrc/conv_same_bwd.cu``, its plain PyTorch versions, and the
autograd Function that puts it under VGG ``conv1_1``.

Replaces the TPU kernel ``fast_neural_style_transfer_tpu/ops/pallas_conv.py::
_bwd_kernel`` (``conv2d_same_bwd``, ``conv2d_same_dx``). dx-only takes one
of two kernels, picked by ``plan_conv_dx`` from the shape alone: the
tap-packed tensor-core kernel (route "tap_packed": C_out = 64, k >= 3,
k*k*C_in <= 32, g 16-byte aligned, w in g's dtype; VGG conv1_1) or the
tiled kernel (route "tiled": every other shape in the gate, and full mode).
dx-only is bound by bytes (read the 64-channel gradient once, write the
3-channel dx once); the source file states the bound, the layout and the
designs.

Tensors are PyTorch's: g (N, C_out, H, W) and x, dx (N, C_in, H, W) in
``torch.channels_last`` memory format (physically NHWC), w (C_out, C_in, k,
k). dw and db come back float32. The gate is the kernel's own: odd k <= 11,
stride 1, k*k*C_in <= 128, any H and W (the TPU's H % 16 and W % 128 came
from its tiling). On a CUDA tensor a shape outside the gate raises; it never
goes quietly to cuDNN.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from fast_neural_style_transfer_tpu_torch.ops import _build

_TILE_H, _TILE_W = 8, 32  # kTH, kTW in the source
_MAX_FULL_BLOCKS = 4 * 132  # persistent grid of the full mode: 4 per SM
_SMEM_LIMIT = 232_448  # bytes of shared memory one Hopper block may use
_SMS = 132  # an H100 SXM's SMs

# the tap-packed kernel (tp:: in the source)
_TP_STRIP = 64  # kSW: output columns of a strip
_TP_STAGES = 4  # kStages: g rows in flight, less one
_TP_CO = 64  # kCO: the C_out it takes
_TP_COLS = 32  # 8 * kNT: P columns, k*k*C_in at most


class _Lib(NamedTuple):
    bwd: ctypes._CFuncPtr  # the tiled kernel (dx-only or full)
    bwd_smem: ctypes._CFuncPtr
    dx: ctypes._CFuncPtr  # the tap-packed kernel
    dx_smem: ctypes._CFuncPtr
    dx_occupancy: ctypes._CFuncPtr


_lib: Optional[_Lib] = None


def _kernel() -> _Lib:
    global _lib
    if _lib is None:
        lib = _build.load("conv_same_bwd")
        bwd = lib.fnst_conv_same_bwd
        bwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        bwd.restype = ctypes.c_int
        dx = lib.fnst_conv_dx_tap_packed
        dx.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        dx.restype = ctypes.c_int
        for fn in (lib.fnst_conv_same_bwd_smem, lib.fnst_conv_dx_tap_packed_smem):
            fn.argtypes = [ctypes.c_int] * 3
            fn.restype = ctypes.c_longlong
        occ = lib.fnst_conv_dx_tap_packed_occupancy
        occ.argtypes = [ctypes.c_int] * 3
        occ.restype = ctypes.c_int
        _lib = _Lib(bwd, lib.fnst_conv_same_bwd_smem, dx,
                    lib.fnst_conv_dx_tap_packed_smem, occ)
    return _lib


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


# -- the dx planner ---------------------------------------------------------------


class ConvDxPlan(NamedTuple):
    """How one ``conv2d_same_dx`` call runs (``plan_conv_dx``)."""

    route: str  # "tap_packed" or "tiled"
    strip: int  # output columns a block spans (its strip, or its tile)
    rows: int  # rows a block owns (tap_packed: the most over its pieces), or the tile's
    stages: int  # g rows the block has in flight (tap_packed), else 0
    blocks: int  # the grid
    smem_bytes: int  # dynamic shared memory of a block


def tap_packed_smem_bytes(k: int, c_in: int, itemsize: int) -> int:
    """Dynamic shared memory of a tap-packed block, as the source sizes it
    (tp::layout): the g stages, the ring of k P rows in f32 (odd pixel
    stride), two dx row segments and, in f32, W' as 16-byte fragment packs,
    each rounded up to 16 bytes."""
    cols, kkc = _TP_STRIP + 2 * (k // 2), k * k * c_in
    ring = k * cols * (kkc | 1) * 4
    seg = -(-(_TP_STRIP * c_in * itemsize + 16) // 16) * 16
    frags = (_TP_CO // 8) * -(-kkc // 8) * 32 * 16 if itemsize == 4 else 0
    return _TP_STAGES * cols * _TP_CO * itemsize + -(-ring // 16) * 16 + 2 * seg + frags


def tiled_smem_bytes(k: int, c_in: int, full: bool = False) -> int:
    """Dynamic shared memory of a tiled block (smem_bytes in the source)."""
    ci4 = 4 * -(-c_in // 4)
    stride = (_TILE_W + 2 * (k // 2)) | 1
    floats = 32 * k * k * ci4 + (_TILE_H + 2 * (k // 2)) * 32 * stride
    if full:
        floats += (_TILE_H + 2 * (k // 2)) * c_in * stride
    return 4 * floats


def plan_conv_dx(n: int, h: int, w: int, c_in: int, c_out: int, k: int,
                 dtype: torch.dtype, aligned: bool, *, w_same_dtype: bool = True,
                 sms: int = _SMS, blocks_per_sm: Optional[int] = None,
                 tap_packed: bool = True) -> ConvDxPlan:
    """The dx kernel and its grid for g (n, c_out, h, w) and a k x k
    weight with c_in inputs, g in ``dtype``; ``aligned``: g's pointer is on
    16 bytes; ``w_same_dtype``: w comes in g's dtype.

    "tap_packed" iff c_out == 64, k >= 3, k*k*c_in <= 32 (so k, c_in is
    3, 1..3 or 5, 1), aligned and w_same_dtype (``tap_packed=False`` gives
    the tiled plan, for timing it). Its grid is one wave of ``sms`` x
    ``blocks_per_sm`` blocks (by default the blocks an SM is built to hold:
    4 in bf16, 2 in f32; the wrapper asks the card), at most one a row:
    the n x ceil(w / 64) x h row segments, numbered sample by sample,
    strip by strip, row by row, are cut into equal contiguous ranges, one a
    block (block b: [b S / blocks, (b + 1) S / blocks)), walked as pieces
    that end at a strip's last row. Otherwise "tiled": one block per 8 x
    32 tile."""
    itemsize = dtype.itemsize
    if (tap_packed and c_out == _TP_CO and k >= 3 and k * k * c_in <= _TP_COLS
            and aligned and w_same_dtype):
        smem = tap_packed_smem_bytes(k, c_in, itemsize)
        if blocks_per_sm is None:
            blocks_per_sm = 4 if itemsize == 2 else 2
        segments = n * -(-w // _TP_STRIP) * h
        blocks = max(1, min(segments, sms * blocks_per_sm))
        return ConvDxPlan("tap_packed", _TP_STRIP, -(-segments // blocks), _TP_STAGES,
                          blocks, smem)
    return ConvDxPlan("tiled", _TILE_W, _TILE_H, 0,
                      n * -(-h // _TILE_H) * -(-w // _TILE_W), tiled_smem_bytes(k, c_in))


_occupancy: Dict[tuple, Tuple[int, int]] = {}


def conv_dx_plan(g: torch.Tensor, w: torch.Tensor, *, tap_packed: bool = True
                 ) -> ConvDxPlan:
    """The plan ``conv2d_same_dx`` follows for the CUDA tensors g and w
    (the tap-packed grid from the card's SMs and the blocks an SM holds,
    asked of the card once per device and shape class; with
    ``tap_packed=False``: the tiled kernel's plan, for timing it)."""
    n, co, h, wd = g.shape
    ci, k = w.shape[1], w.shape[-1]
    args = (n, h, wd, ci, co, k, g.dtype, g.data_ptr() % 16 == 0)
    same = w.dtype == g.dtype
    plan = plan_conv_dx(*args, w_same_dtype=same, tap_packed=tap_packed)
    if plan.route != "tap_packed":
        return plan
    bf16 = int(g.dtype == torch.bfloat16)
    key = (g.device.index, k, ci, bf16)
    if key not in _occupancy:
        # the query sets the kernel's shared-memory attribute on the
        # runtime's current device: make that g's card
        with torch.cuda.device(g.device):
            per_sm = _kernel().dx_occupancy(k, ci, bf16)
        if per_sm < 1:
            raise RuntimeError(f"tap-packed dx kernel: occupancy query failed ({per_sm})")
        sms = torch.cuda.get_device_properties(g.device).multi_processor_count
        _occupancy[key] = (per_sm, sms)
    per_sm, sms = _occupancy[key]
    return plan_conv_dx(*args, w_same_dtype=same, sms=sms, blocks_per_sm=per_sm)


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
    """The tiled kernel: dx-only or full (inputs already checked)."""
    n, co, h, wd = g.shape
    ci, k = w.shape[1], w.shape[-1]
    lib = _kernel()
    if lib.bwd_smem(k, ci, int(full)) > _SMEM_LIMIT:
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
    err = _build.on_card(
        g.device, lib.bwd, g.data_ptr(), x.data_ptr() if full else 0, wpk.data_ptr(),
        dx.data_ptr(), work.data_ptr() if full else 0, dwb.data_ptr() if full else 0,
        n, h, wd, ci, co, k, int(full), blocks, int(g.dtype == torch.bfloat16))
    if err != 0:
        raise RuntimeError(f"conv backward kernel launch failed: CUDA error {err}")
    if not full:
        return dx
    dw = dwb[:k * k * ci * co].view(k, k, ci, co).permute(3, 2, 0, 1).contiguous()
    return dx, dw, dwb[k * k * ci * co:]


def _launch_dx(g: torch.Tensor, w: torch.Tensor, plan: ConvDxPlan) -> torch.Tensor:
    """One dx-only call on the card as ``plan`` says (inputs already
    checked); counts the launch in all and by route."""
    if plan.route == "tiled":
        dx = _launch(g, None, w, full=False)
    else:
        n, co, h, wd = g.shape
        ci, k = w.shape[1], w.shape[-1]
        dx = torch.empty((n, ci, h, wd), dtype=g.dtype, device=g.device,
                         memory_format=torch.channels_last)
        wc = w.detach().contiguous()
        err = _build.on_card(
            g.device, _kernel().dx, g.data_ptr(), wc.data_ptr(), dx.data_ptr(), n, h,
            wd, ci, co, k, plan.blocks, int(g.dtype == torch.bfloat16))
        if err != 0:
            raise RuntimeError(f"tap-packed dx kernel launch failed: CUDA error "
                               f"{err} ({plan})")
    conv2d_same_dx.launches += 1
    conv2d_same_dx.launches_by_route[plan.route] += 1
    return dx


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
    that ``plan_conv_dx`` picks, or raises: a shape outside the gate, a
    wrong dtype or layout, a failed build or a failed launch."""
    if not _device_ok(g, "conv2d_same_dx"):
        return conv2d_same_dx_reference(g, w)
    _check(g, w, None)
    return _launch_dx(g, w, conv_dx_plan(g, w))


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


# calls that launched a kernel: dx-only in all and by route; full mode
_build.counted(conv2d_same_dx, route=("tap_packed", "tiled"))
_build.counted(conv2d_same_bwd)


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
