"""Reflect padding on the card: the wrapper of ``csrc/reflect_pad.cu``, its
plain PyTorch version and its planner.

``reflect_pad(x, pad, relu=, upsample=)`` computes ``pad_reflect(up(relu(x)))``
in one pass: the optional ReLU (``torch.relu``'s edge cases on the card: -0
becomes +0, NaN passes; on the CPU ``torch.relu``, and so the plain version,
keeps -0), the optional nearest x2 upsample (PyTorch's: output index i reads
input index i // 2), then PyTorch's reflect padding of H and W by ``pad`` on
each side. It is pure data movement and ``max(0, .)``, so the
kernel, its plain version and ``F.pad(F.interpolate(torch.relu(x)))`` agree
bit for bit. ``ops/conv.py::reflect_pad_hw`` routes to it.

Replaces no TPU kernel (the JAX package's ``jnp.pad`` was lowered by XLA).
PyTorch's CUDA reflection pad works in NCHW, so on a channels_last tensor
it transposes to NCHW and back around the pad; the kernel reads and writes
NHWC directly, bound by bytes (read x once, write y once). The source file
states the bound and the design; ``plan_pad`` picks its route and word.

Tensors are (N, C, H, W) in ``torch.channels_last`` memory format
(physically NHWC), bf16 or f32; y comes back the same.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from fast_neural_style_transfer_tpu_torch.ops import _build

_SEG_WORDS = 256 * 4  # kSegWords in the source: most words a block moves

_fn: Optional[ctypes._CFuncPtr] = None


def _kernel() -> ctypes._CFuncPtr:
    global _fn
    if _fn is None:
        fn = _build.load("reflect_pad").fnst_reflect_pad
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


@functools.lru_cache(maxsize=64)
def source_index(n: int, pad: int, upsample: int = 1, device=None) -> torch.Tensor:
    """Source indices of an axis of n entries, upsampled ``upsample`` times
    (nearest), then reflect-padded by ``pad`` on each side: the kernel's
    ``src_index`` for every output index. Cached: the int8 path gathers by
    it at every conv of every forward. Read-only."""
    nu = n * upsample
    t = torch.arange(-pad, nu + pad, device=device).abs()
    t = torch.where(t >= nu, 2 * (nu - 1) - t, t)
    return t // upsample


def _check_args(x: torch.Tensor, pad: int, upsample: int) -> None:
    """Raises unless x is (N, C, H, W) and the pad fits PyTorch's reflect
    rule (less than each upsampled side)."""
    if x.dim() != 4:
        raise ValueError(f"reflect_pad wants (N, C, H, W), got {tuple(x.shape)}")
    if upsample not in (1, 2):
        raise ValueError(f"reflect_pad upsamples by 1 or 2, not {upsample}")
    h, w = x.shape[2] * upsample, x.shape[3] * upsample
    if not 0 <= pad < min(h, w):
        raise ValueError(f"reflect padding {pad} needs sides above it, got {h}x{w}")


def reflect_pad_reference(x: torch.Tensor, pad: int, *, relu: bool = False,
                          upsample: int = 1) -> torch.Tensor:
    """Plain PyTorch version of the kernel: its index map as two
    ``index_select``s on the NHWC view (source rows, then source pixels),
    the ReLU as ``torch.relu``; channels_last out."""
    _check_args(x, pad, upsample)
    n, c, h, w = x.shape
    if relu:
        x = torch.relu(x)
    y = (x.permute(0, 2, 3, 1)
          .index_select(1, source_index(h, pad, upsample, x.device))
          .index_select(2, source_index(w, pad, upsample, x.device)))
    return y.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


class PadPlan(NamedTuple):
    """How one ``reflect_pad`` call runs (``plan_pad``)."""

    route: str  # "pixel": a word inside one pixel; "gather": words straddle pixels
    vec: int  # bytes of a word
    rows: int  # output rows, N * Ho: the grid's x
    row_words: int  # words of an output row
    segs: int  # blocks of a row: the grid's y
    seg_words: int  # words a block moves


def _pow2_dividing(v: int, cap: int = 16) -> int:
    """The largest power of two up to ``cap`` that divides v (v > 0)."""
    return min(v & -v, cap)


def plan_pad(n: int, c: int, h: int, w: int, itemsize: int, pad: int,
             upsample: int, x_ptr: int) -> PadPlan:
    """The kernel's route and word for n samples of (h, w, c) at ``itemsize``
    bytes, x at address ``x_ptr``. The word is the largest power of two up
    to 16 bytes that divides the output row's bytes; the pixel route takes
    it where it also divides a pixel's bytes and x's address (one load a
    word), else the gather route (element loads, one 16-byte store where
    the row allows: the 3-channel RGB sites). Each output row is split into
    the fewest even segments of at most 1024 words."""
    ho, wo = h * upsample + 2 * pad, w * upsample + 2 * pad
    row_bytes = wo * c * itemsize
    vec = _pow2_dividing(row_bytes)
    pixel = vec == _pow2_dividing(c * itemsize) and x_ptr % vec == 0
    row_words = row_bytes // vec
    segs = -(-row_words // _SEG_WORDS)
    seg_words = -(-row_words // segs)
    return PadPlan("pixel" if pixel else "gather", vec, n * ho, row_words, segs, seg_words)


def _check(x: torch.Tensor, pad: int, upsample: int) -> None:
    """Raises unless the kernel takes x: a non-empty channels_last (N, C, H,
    W) float32 or bfloat16 tensor, a pad below each upsampled side."""
    _check_args(x, pad, upsample)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the reflect-pad kernel takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("the reflect-pad kernel wants a channels_last contiguous x")
    if x.numel() == 0:
        raise ValueError(f"the reflect-pad kernel got an empty tensor {tuple(x.shape)}")


def reflect_pad(x: torch.Tensor, pad: int, *, relu: bool = False,
                upsample: int = 1) -> torch.Tensor:
    """``pad_reflect(up(relu(x)))`` of a CUDA tensor as a new channels_last
    tensor, by one launch of the kernel, or raises: another device, wrong
    dtype, layout or pad, a failed build or a failed launch. No gradient
    flows through it; ``ops/conv.py::reflect_pad_hw`` routes, and counts
    the launches."""
    if x.device.type != "cuda":
        raise ValueError(f"the reflect-pad kernel runs on cuda, not {x.device}")
    _check(x, pad, upsample)
    n, c, h, w = x.shape
    plan = plan_pad(n, c, h, w, x.element_size(), pad, upsample, x.data_ptr())
    y = torch.empty((n, c, h * upsample + 2 * pad, w * upsample + 2 * pad),
                    dtype=x.dtype, device=x.device, memory_format=torch.channels_last)
    err = _build.on_card(
        x.device, _kernel(), x.data_ptr(), y.data_ptr(), n, c, h, w, pad, upsample,
        int(relu), int(x.dtype == torch.bfloat16), plan.vec, int(plan.route == "gather"),
        plan.seg_words, plan.segs)
    if err != 0:
        raise RuntimeError(f"reflect-pad kernel launch failed: CUDA error {err} ({plan})")
    return y
