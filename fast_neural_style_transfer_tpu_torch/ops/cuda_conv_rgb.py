"""The stylizer's last convolution (32 -> 3 channels, 9 x 9, stride 1) on
the card: the wrapper of ``csrc/conv_to_rgb.cu``, its plain PyTorch version,
its route and its planner.

``conv_to_rgb(xp, weight, bias)`` computes ``F.conv2d(xp, weight, bias)``
of an input already reflect-padded by 4 (``ops/conv.py::reflect_pad_hw``
stages it): bf16 operands, every product and sum in float32, the bias added
in float32 and the output rounded once to bf16, as cuDNN's TF32 kernel did
(a bf16 value is exact in TF32); only the order of the sums differs. On a
card it is one launch of the kernel, counted in ``conv_to_rgb.launches``;
on the CPU the plain version, float32 ``F.conv2d`` of the same bf16
operands. A CUDA tensor the kernel does not take raises: the plain version
does not stand in for it on a card.

``takes_rgb`` is the route ``ops/conv.py::reflect_conv2d`` asks: a bf16
channels_last CUDA input that needs no gradient, a (3, 32, 9, 9) weight,
stride 1, no ReLU and no upsample read through the pad. That is stylenet's
``final_conv`` in every bf16 forward on a card (the serving graphs, the
CLI, video); training (a gradient, float32), float32 forwards, int8
calibration, the sharded path (``ops/sharded.py`` calls ``F.conv2d``
itself) and the decoders' 64 -> 3 3 x 3 convs stay on cuDNN.

``plan_rgb`` splits a row into even strips and hands each of the card's
SMs an equal run of output rows (a block holds an SM: one wave), through
the (image, strip) columns in turn.

Replaces no TPU kernel: the JAX package left the conv to XLA. The source
file states the bound and the design.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from fast_neural_style_transfer_tpu_torch.ops import _build

# the one weight shape the kernel takes: (C_out, C_in, k, k)
WEIGHT_SHAPE = (3, 32, 9, 9)
PAD = WEIGHT_SHAPE[-1] // 2
STRIP = 104  # kStrip in the source: the most output columns of a strip

_fn: Optional[ctypes._CFuncPtr] = None


def _kernel() -> ctypes._CFuncPtr:
    global _fn
    if _fn is None:
        fn = _build.load("conv_to_rgb").fnst_conv_to_rgb
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def takes_rgb(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], *,
              stride: int = 1, relu: bool = False, upsample: int = 1) -> bool:
    """Whether ``reflect_conv2d`` of x (before its pad) goes to the kernel."""
    needs_grad = torch.is_grad_enabled() and (
        x.requires_grad or weight.requires_grad or (bias is not None and bias.requires_grad))
    return (x.device.type == "cuda" and x.dtype == torch.bfloat16 and not needs_grad
            and tuple(weight.shape) == WEIGHT_SHAPE and stride == 1 and not relu
            and upsample == 1 and x.dim() == 4
            and x.is_contiguous(memory_format=torch.channels_last))


class RgbPlan(NamedTuple):
    """How one ``conv_to_rgb`` call runs (``plan_rgb``)."""

    strips: int  # strips across a row
    strip: int  # output columns of a strip
    rows: int  # output rows a block runs through, (image, strip) columns in turn
    blocks: int  # the grid


def plan_rgb(n: int, h: int, w: int, sms: int) -> RgbPlan:
    """The grid for an (n, h, w) output on a card of ``sms`` SMs: a row in
    the fewest strips of at most STRIP columns, split evenly (so that every
    block runs about as many warps); the n * strips * h output rows of all
    columns split into at most ``sms`` equal runs, one a block."""
    strips = -(-w // STRIP)
    total = n * strips * h
    rows = -(-total // min(sms, total))
    return RgbPlan(strips, -(-w // strips), rows, -(-total // rows))


@functools.lru_cache(maxsize=16)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_args(xp: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor]) -> None:
    """Raises unless xp is (N, 32, H + 8, W + 8) with H, W >= 5, the weight
    (3, 32, 9, 9) and the bias (3,) or None."""
    if xp.dim() != 4 or xp.shape[1] != WEIGHT_SHAPE[1]:
        raise ValueError(f"conv_to_rgb wants xp (N, 32, H + 8, W + 8), got {tuple(xp.shape)}")
    if tuple(weight.shape) != WEIGHT_SHAPE:
        raise ValueError(f"conv_to_rgb takes a {WEIGHT_SHAPE} weight, got {tuple(weight.shape)}")
    if bias is not None and tuple(bias.shape) != (WEIGHT_SHAPE[0],):
        raise ValueError(f"conv_to_rgb takes a (3,) bias, got {tuple(bias.shape)}")
    if min(xp.shape[2], xp.shape[3]) < 2 * PAD + 5:
        raise ValueError(f"conv_to_rgb needs outputs of 5 x 5 or more, got xp {tuple(xp.shape)}")


def conv_to_rgb_reference(xp: torch.Tensor, weight: torch.Tensor,
                          bias: Optional[torch.Tensor]) -> torch.Tensor:
    """The plain version: float32 ``F.conv2d`` of the operands as given,
    rounded once to xp's dtype; channels_last out."""
    _check_args(xp, weight, bias)
    y = F.conv2d(xp.float(), weight.float(), None if bias is None else bias.float())
    return y.to(xp.dtype).contiguous(memory_format=torch.channels_last)


def _check(xp: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor]) -> None:
    """Raises unless the kernel takes the operands: all bf16 on xp's card,
    xp channels_last and 16-byte aligned, the bias contiguous."""
    _check_args(xp, weight, bias)
    if {xp.dtype, weight.dtype} | ({bias.dtype} if bias is not None else set()) != {
            torch.bfloat16}:
        raise TypeError("the conv_to_rgb kernel takes bfloat16 xp, weight and bias")
    if weight.device != xp.device or (bias is not None and bias.device != xp.device):
        raise ValueError("the conv_to_rgb kernel wants its operands on xp's card")
    if not xp.is_contiguous(memory_format=torch.channels_last) or xp.data_ptr() % 16:
        raise ValueError("the conv_to_rgb kernel wants a channels_last, 16-byte aligned xp")
    if bias is not None and not bias.is_contiguous():
        raise ValueError("the conv_to_rgb kernel wants a contiguous bias")


def conv_to_rgb(xp: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor]) -> torch.Tensor:
    """The conv of a reflect-padded (N, 32, H + 8, W + 8) input -> (N, 3,
    H, W) channels_last. On a card: one launch of the kernel, bf16 only;
    on the CPU: the plain version; another device raises."""
    if xp.device.type == "cpu":
        return conv_to_rgb_reference(xp, weight, bias)
    if xp.device.type != "cuda":
        raise ValueError(f"the conv_to_rgb kernel runs on cuda, not {xp.device}")
    _check(xp, weight, bias)
    n, _, hp, wp = xp.shape
    h, w = hp - 2 * PAD, wp - 2 * PAD
    plan = plan_rgb(n, h, w, _sms(xp.device))
    y = torch.empty((n, WEIGHT_SHAPE[0], h, w), dtype=xp.dtype, device=xp.device,
                    memory_format=torch.channels_last)
    err = _build.on_card(xp.device, _kernel(), xp.data_ptr(), weight.data_ptr(),
                         None if bias is None else bias.data_ptr(), y.data_ptr(), n, h, w,
                         plan.strip, plan.rows, *weight.stride())
    if err != 0:
        raise RuntimeError(f"conv_to_rgb kernel launch failed: CUDA error {err} "
                           f"(xp {tuple(xp.shape)}, {plan})")
    conv_to_rgb.launches += 1
    return y


# the kernel's launches
_build.counted(conv_to_rgb)
