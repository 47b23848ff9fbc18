"""AdaAttN's moment attention on the card: the wrapper of
``csrc/moment_attention.cu``, its plain PyTorch version, and the per-style
preparation of the values both read.

For queries q (B, Nq, Dqk), keys k (Nk, Dqk) shared by the batch, values v
(Nk, Dv) and c (B, Nq, Dv), the normalized content feature, with
``A = softmax(q k^T)`` (no scaling), ``M = A v``, ``S = sqrt(relu(A v^2 -
M^2))``, the output is ``S * c + M`` (Liu et al., ICCV 2021, eq. 4-6).

``prepare_values(v)`` computes once per style, in float32, the shift (the
values' channel mean over the keys), v1 = v - shift rounded to the compute
dtype and v2 the square of that rounded v1, rounded once, stored as one
(2, Dv, Nkp) tensor: transposed, so that the kernel reads the keys as the
contiguous depth of its value products, and the keys padded with zeros to
Nkp, a multiple of 8. The variance does
not change under the shift, and its moments are then of the size of the
spread, so E[v1^2] - E[v1]^2 does not cancel where |M| >> S;
``moment_attention`` adds the shift back to the mean.

``moment_attention`` launches the kernel for bf16 CUDA tensors, once for
the batch, and counts it in ``moment_attention.launches``; on the CPU it
runs the plain version, the bmm / softmax / bmm composition in float32, in
blocks of queries. CUDA tensors of another dtype are refused: the kernel
has no float32 variant, and the plain version does not stand in for it on
a card. The kernel is built on its
first launch (``ops/_build.py``), never at import, and is not among the
sources the other paths build together.

Replaces no TPU kernel: the JAX package has no AdaAttN. The source file
states the bound, the design and what splitting Dv costs.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from fast_neural_style_transfer_tpu_torch.ops import _build

# the query and key width of a chunk the kernel copies, the value columns
# a warpgroup owns (csrc: kBd, kDv), and the keys of the values' rows a
# multiple of
QK_CHUNK = 64
DV_BLOCK = 128
KEY_PAD = 8
# queries a block of the plain version scores at once
PLAIN_BLOCK_Q = 4096

_fn: Optional[ctypes._CFuncPtr] = None


def _kernel() -> ctypes._CFuncPtr:
    global _fn
    if _fn is None:
        fn = _build.load("moment_attention").fnst_moment_attention
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


class MomentValues(NamedTuple):
    """A style's values as both versions read them."""

    values: torch.Tensor  # (2, Dv, Nkp): v - shift and (v - shift)^2, transposed, padded
    shift: torch.Tensor  # (Dv,) float32


def prepare_values(v: torch.Tensor, dtype: torch.dtype) -> MomentValues:
    """(Nk, Dv) values -> their shifted first power in ``dtype`` and its
    square, formed in float32 from the rounded first and rounded once, and
    the shift: both moments then weigh one set of values."""
    vf = v.float()
    shift = vf.mean(dim=0)
    v1 = (vf - shift).to(dtype)
    nk, dv = v.shape
    values = torch.zeros((2, dv, -(-nk // KEY_PAD) * KEY_PAD), dtype=dtype, device=v.device)
    values[0, :, :nk] = v1.t()
    values[1, :, :nk] = v1.float().square().to(dtype).t()
    return MomentValues(values, shift.contiguous())


def moment_attention_reference(q: torch.Tensor, k: torch.Tensor, mv: MomentValues,
                               c: torch.Tensor, block_q: int = PLAIN_BLOCK_Q) -> torch.Tensor:
    """The plain version: scores, softmax and both moments by bmm in
    float32, ``PLAIN_BLOCK_Q`` queries at a time; out in q's dtype."""
    kf = k.float().t()
    v1, v2 = mv.values[:, :, :k.shape[0]].float().transpose(1, 2)
    out = torch.empty(c.shape, dtype=q.dtype, device=q.device)
    for i in range(0, q.shape[1], block_q):
        a = torch.softmax(q[:, i:i + block_q].float() @ kf, dim=-1)
        m = a @ v1
        s = torch.sqrt(torch.relu(a @ v2 - m.square()))
        out[:, i:i + block_q] = (s * c[:, i:i + block_q].float() + m + mv.shift).to(q.dtype)
    return out


def _check(q: torch.Tensor, k: torch.Tensor, mv: MomentValues, c: torch.Tensor) -> int:
    """Raises unless the kernel takes the operands -> c's row stride."""
    if q.dtype != torch.bfloat16 or {k.dtype, mv.values.dtype, c.dtype} != {torch.bfloat16}:
        raise TypeError("the moment-attention kernel takes bfloat16 q, k, values and c")
    if mv.shift.dtype != torch.float32:
        raise TypeError("the moment-attention kernel takes a float32 shift")
    b, nq, dqk = q.shape
    nk, dv, nkp = k.shape[0], mv.values.shape[1], mv.values.shape[-1]
    if (tuple(k.shape) != (nk, dqk) or tuple(mv.values.shape) != (2, dv, nkp) or nk < 1
            or nkp < nk or nkp % KEY_PAD):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, values "
                         f"{tuple(mv.values.shape)} do not match")
    if tuple(c.shape) != (b, nq, dv) or tuple(mv.shift.shape) != (dv,):
        raise ValueError(f"c {tuple(c.shape)} / shift {tuple(mv.shift.shape)} do not match "
                         f"(B, Nq, Dv) = {(b, nq, dv)}")
    if dqk % QK_CHUNK or dv % DV_BLOCK:
        raise ValueError(f"the kernel needs Dqk a multiple of {QK_CHUNK} and Dv of "
                         f"{DV_BLOCK}, got {dqk} and {dv}")
    if not (q.is_contiguous() and k.is_contiguous() and mv.values.is_contiguous()):
        raise ValueError("the kernel wants contiguous q, k and values")
    if q.data_ptr() % 16 or k.data_ptr() % 16 or mv.values.data_ptr() % 16:
        raise ValueError("the kernel's copies want q, k and values 16-byte aligned")
    rs = c.stride(1)
    if c.stride(2) != 1 or c.stride(0) != nq * rs or rs % 8 or c.data_ptr() % 16:
        raise ValueError(f"c must be rows of a (B, Nq, D) buffer, 16-byte aligned "
                         f"(strides {c.stride()})")
    return rs


def moment_attention(q: torch.Tensor, k: torch.Tensor, mv: MomentValues,
                     c: torch.Tensor) -> torch.Tensor:
    """``S * c + M`` (B, Nq, Dv) in q's dtype for queries q (B, Nq, Dqk),
    keys k (Nk, Dqk), a style's ``prepare_values`` and c (B, Nq, Dv) (a
    view is fine: the kernel reads it in place). On a card: one launch of
    the kernel, bf16 only; on the CPU: the plain version."""
    if q.device.type != "cuda":
        return moment_attention_reference(q, k, mv, c)
    rs = _check(q, k, mv, c)
    b, nq, dqk = q.shape
    nk, dv, nkp = k.shape[0], mv.values.shape[1], mv.values.shape[-1]
    out = torch.empty((b, nq, dv), dtype=q.dtype, device=q.device)
    err = _build.on_card(q.device, _kernel(), q.data_ptr(), k.data_ptr(), mv.values.data_ptr(),
                         mv.shift.data_ptr(), c.data_ptr(), out.data_ptr(), b, nq, nk, nkp, dqk,
                         dv, rs)
    if err != 0:
        raise RuntimeError(f"moment-attention kernel launch failed: error {err} "
                           f"(q {tuple(q.shape)}, k {tuple(k.shape)}, Dv {dv})")
    moment_attention.launches += 1
    return out


# the kernel's launches
_build.counted(moment_attention)
