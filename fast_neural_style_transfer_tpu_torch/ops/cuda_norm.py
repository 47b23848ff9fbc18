"""Instance norm on the card: the wrappers of ``csrc/instance_norm.cu``
(forward and backward), their plain PyTorch versions, their planners, and
the autograd Function that joins them.

Replaces the TPU kernels ``fast_neural_style_transfer_tpu/ops/pallas_norm.py::
_in_fwd_kernel`` and ``_in_bwd_kernel``. Both kernels are bound by bytes
(forward: read x, write y; backward: read x and g, write dx); the source
file states the bounds and the designs. Each direction has two kernels, a
one-launch kernel that holds a sample's chunks on chip (shared memory, and
registers in the f32 backward) and a two-launch kernel for any slab;
``plan_fwd`` and ``plan_bwd`` pick one by shape (their docstrings state the
rules). Every IN site of the stylizer runs on the kernels at every batch
size, with no fallback.

Activations are NCHW tensors in ``torch.channels_last`` memory format, i.e.
physically NHWC, the layout the TPU kernels saw. The affine (gamma, beta) is
(C,), one row for the batch, or (N, C), a row per sample (conditional
instance norm: multi-style training conditions each example on its own
style; the JAX package sends that shape to XLA, the port's kernels read it
per sample). ``mean`` and ``inv`` come back as (N, C) float32, and so do the
per-sample ``dgamma`` and ``dbeta``.

The forward has two more modes (video's frozen statistics): capture
(``instance_norm_fwd(capture=True)`` also returns the (N, C) f32 var the
kernel normalized with) and inject (``instance_norm_apply_stats``: normalize
with reference moments, or a blend of them with x's own). Both share the
kernel's scale/shift and apply code, so capture then inject at blend 1 is
the plain forward bit for bit. ``launches_by_mode`` counts them.

The sharded forms (an image's rows split over ranks, ``ops/sharded.py``):
the statistics-only route and the inject apply with the ranks' merged
moments forward, the sums and dx passes with the ranks' summed sums
backward (``ShardedInstanceNormFn``; the section at the end of this file).
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from fast_neural_style_transfer_tpu_torch.ops import _build

# two-launch backward
_TILE_C = 32  # channels per block (kTileC in the source)
_MIN_CHUNK = 256  # fewest pixels a block reduces
_MAX_CHUNKS = 64  # most chunk partials each apply block re-reads
_TARGET_BLOCKS = 4 * 132  # about four blocks on each of the H100's 132 SMs

_THREADS = 256  # kThreads in the source: threads of a one-launch block
# two-launch forward: most (chunk, channel) partials of a sample, all of
# which the sample's last block merges
_FWD_PARTIALS = 8192

_fns = None
_capacities: Dict[tuple, Tuple[int, int]] = {}


class _Lib(NamedTuple):
    """The library's entry points."""

    fwd: Callable
    fwd_stats: Callable
    bwd: Callable
    fwd_capacity: Callable
    bwd_capacity: Callable
    bwd_sums: Callable
    bwd_apply: Callable


def _kernels() -> _Lib:
    global _fns
    if _fns is None:
        lib = _build.load("instance_norm")
        fwd = lib.fnst_instance_norm_fwd
        fwd.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                        + [ctypes.c_float] + [ctypes.c_int] * 5
                        + [ctypes.c_void_p])
        fwd.restype = ctypes.c_int
        fwd_stats = lib.fnst_instance_norm_fwd_stats
        fwd_stats.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 8
                              + [ctypes.c_float] * 3 + [ctypes.c_int] * 4
                              + [ctypes.c_void_p])
        fwd_stats.restype = ctypes.c_int
        bwd = lib.fnst_instance_norm_bwd
        bwd.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 10
                        + [ctypes.c_void_p])
        bwd.restype = ctypes.c_int
        fwd_cap = lib.fnst_instance_norm_fwd_capacity
        fwd_cap.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 2
        fwd_cap.restype = ctypes.c_int
        bwd_cap = lib.fnst_instance_norm_bwd_capacity
        bwd_cap.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 2
        bwd_cap.restype = ctypes.c_int
        bwd_sums = lib.fnst_instance_norm_bwd_sums
        bwd_sums.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        bwd_sums.restype = ctypes.c_int
        bwd_apply = lib.fnst_instance_norm_bwd_apply
        bwd_apply.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                              + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        bwd_apply.restype = ctypes.c_int
        _fns = _Lib(fwd, fwd_stats, bwd, fwd_cap, bwd_cap, bwd_sums, bwd_apply)
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
    capture: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the kernel: same outputs, f32 statistics;
    gamma and beta (C,) or (N, C). ``onepass`` selects var = max(E[x^2] -
    mean^2, 0) (the TPU kernel's arithmetic) over the two-pass variance
    around the mean. ``capture``: also return the (N, C) f32 var."""
    xf = x.float()
    mean, var = _moments(xf, onepass)
    y, inv = _normalize(xf, mean, var, gamma, beta, eps=eps, relu=relu)
    y = y.to(x.dtype)
    return (y, mean, inv, var) if capture else (y, mean, inv)


def _normalize(xf, mean, var, gamma, beta, *, eps: float, relu: bool):
    """y = x * scale + shift (+ReLU) in f32 from (N or 1, C) moments, the
    kernels' arithmetic (``scale_shift``, ``apply_chunk``) -> (y, inv)."""
    inv = torch.rsqrt(var + eps)
    scale = inv * gamma.float()
    shift = beta.float() - mean * scale
    y = xf * scale[:, :, None, None] + shift[:, :, None, None]
    if relu:
        y = torch.relu(y)
    return y, inv


def _num_chunks(n: int, hw: int, tiles: int) -> int:
    """Two-launch backward: pixel chunks per (sample, channel tile): enough
    blocks to fill the card, at least _MIN_CHUNK pixels each, at most
    _MAX_CHUNKS."""
    want = -(-_TARGET_BLOCKS // (n * tiles))
    return max(1, min(want, _MAX_CHUNKS, hw // _MIN_CHUNK))


# one-launch forward: most bytes of x a block holds, so that two blocks
# share an SM (chip_smoke.py's in_fwd_budgets phase times 64, 80 and 96 KB)
_FWD_CHUNK_BYTES = 80 * 1024
# kSmemLimit: a one-launch block's most shared memory; two fit an SM's 228 KB
_SMEM_LIMIT = 112 * 1024


class FwdPlan(NamedTuple):
    """How one ``instance_norm_fwd`` call runs (``plan_fwd``)."""

    route: str  # "one_launch" or "two_launch"
    vec: int  # channels per access: a 16-byte pack, or 1
    chunk: int  # pixels per block
    chunks: int  # blocks per sample (G)
    blocks: int  # n * chunks
    chunk_bytes: int  # bytes of x a block owns (its largest chunk)
    smem_bytes: int  # dynamic shared memory of a one-launch block, else 0
    capacity: int  # one-launch blocks the card holds at once


def pack_vec(c: int, itemsize: int, *ptrs: int) -> int:
    """Channels per access: a 16-byte pack where a pixel row is a whole
    number of packs and every tensor the kernel moves in packs (its
    pointers ``ptrs``) is 16-byte aligned, else one element."""
    aligned = all(p % 16 == 0 for p in ptrs)
    return 16 // itemsize if (c * itemsize) % 16 == 0 and aligned else 1


def fwd_smem_bytes(chunk: int, c: int, itemsize: int, vec: int) -> int:
    """Dynamic shared memory of a one-launch block, as the source sizes it:
    the chunk (rounded up to 16 bytes), the lane sums and each channel's
    (scale, shift)."""
    return (-(-chunk * c * itemsize // 16) * 16
            + 4 * _THREADS * max(vec, 2) + 8 * c)


def plan_fwd(n: int, hw: int, c: int, itemsize: int, vec: int, *, sms: int,
             blocks_per_sm: int, one_launch: bool = True,
             sharded: bool = False) -> FwdPlan:
    """The forward's kernel and chunks for n samples of hw pixels x c
    channels, on a card of ``sms`` SMs that holds ``blocks_per_sm``
    one-launch blocks each (``capacity`` = their product).

    One launch: chunks of whole pixel rows, as many pixels as fit
    _FWD_CHUNK_BYTES (and the block's shared memory _SMEM_LIMIT), cut
    smaller, down to one pixel, where the grid would hold fewer than two
    blocks per SM (or the capacity, if less). Every chunk of a sample has to
    be resident at once, so this route is taken iff a sample's chunks G <=
    capacity: a slab up to ~capacity * 80 KB (21 MB on an H100).
    Otherwise (a larger slab, a pixel row above the budget, or
    ``one_launch=False``) two launches: G for about four blocks per SM, at
    most _FWD_PARTIALS / c chunks (the partials a sample's last block
    merges), at least one pixel each. ``sharded`` (the sharded statistics
    pass and apply) drops that cap: a shard is often one large sample (a 4K
    image's rows), which the cap would give 32 blocks at 256 channels; the
    statistics' merge then reads G * c partials, ~1 MB from L2 at c = 512,
    against a slab of hundreds of MB, and the apply merges nothing."""
    row = c * itemsize
    capacity = blocks_per_sm * sms
    fixed = fwd_smem_bytes(0, c, itemsize, vec)
    most = min(_FWD_CHUNK_BYTES, _SMEM_LIMIT - fixed - 15) // row
    if one_launch and most >= 1:
        g = -(-hw // most)
        fill = min(2 * sms, capacity)
        if n * g < fill:
            g = min(hw, -(-fill // n))
        chunk = -(-hw // g)
        g = -(-hw // chunk)
        if g <= capacity:
            return FwdPlan("one_launch", vec, chunk, g, n * g, chunk * row,
                           fwd_smem_bytes(chunk, c, itemsize, vec), capacity)
    g = -(-4 * sms // n)
    if not sharded:
        g = min(g, max(_FWD_PARTIALS // c, 1))
    g = max(1, min(hw, g))
    chunk = -(-hw // g)
    g = -(-hw // chunk)
    return FwdPlan("two_launch", vec, chunk, g, n * g, chunk * row, 0, capacity)


def _capacity(device: torch.device, query: str, *variant: int) -> Tuple[int, int]:
    """(blocks per SM, SMs) of a one-launch kernel on ``device``, from the
    library's ``query`` ("fwd_capacity" or "bwd_capacity") for the kernel
    ``variant``, asked of the card once per device and variant."""
    key = (device.index, query, variant)
    if key not in _capacities:
        per_sm, sms = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(device):
            err = getattr(_kernels(), query)(*variant, ctypes.byref(per_sm),
                                             ctypes.byref(sms))
        if err != 0:
            raise RuntimeError(f"instance-norm capacity query failed: CUDA error {err}")
        _capacities[key] = (per_sm.value, sms.value)
    return _capacities[key]


def _check(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor) -> None:
    """Raises unless x is a non-empty channels_last (N, C, H, W) float32 or
    bfloat16 tensor and gamma, beta are (C,) or (N, C) on x's device."""
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
        if p.shape not in ((c,), (n, c)):
            raise ValueError(f"{name} shape {tuple(p.shape)} is neither ({c},) "
                             f"nor ({n}, {c})")
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
    capture: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Instance norm + affine (+ReLU) -> (y, mean, inv); gamma, beta (C,)
    or (N, C). ``capture``: also return the (N, C) f32 var that inv was
    taken of, -> (y, mean, inv, var); with ``instance_norm_apply_stats`` at
    blend 1 those moments give y's bits again.

    A CPU tensor takes the plain version. A CUDA tensor launches the kernel
    that ``plan_fwd`` picks, or raises: wrong dtype or layout, a failed
    build or a failed launch. Gradients go through ``InstanceNormFn``."""
    if x.device.type == "cpu":
        return instance_norm_fwd_reference(
            x, gamma, beta, eps=eps, relu=relu, onepass=onepass, capture=capture)
    if x.device.type != "cuda":
        raise ValueError(f"instance_norm_fwd runs on cuda or cpu, not {x.device}")
    _check(x, gamma, beta)
    return _launch_fwd(x, gamma, beta, fwd_plan(x, onepass=onepass), eps=eps,
                       relu=relu, onepass=onepass, capture=capture)


def fwd_plan(x: torch.Tensor, *, onepass: bool = False,
             one_launch: bool = True, rows: Optional[int] = None,
             sharded: bool = False) -> FwdPlan:
    """The plan ``instance_norm_fwd`` follows for the CUDA tensor x (with
    ``one_launch=False``: the two-launch kernel's plan, for timing it);
    ``rows``: over the first ``rows`` rows of each sample only (the sharded
    forms' extent); ``sharded``: ``plan_fwd``'s."""
    n, c, h, w = x.shape
    is_bf16 = x.dtype == torch.bfloat16
    vec = pack_vec(c, x.element_size(), x.data_ptr())
    per_sm, sms = _capacity(x.device, "fwd_capacity", int(is_bf16), vec, int(onepass))
    return plan_fwd(n, (h if rows is None else rows) * w, c, x.element_size(), vec,
                    sms=sms, blocks_per_sm=per_sm, one_launch=one_launch,
                    sharded=sharded)


def _affine_rows(gamma: torch.Tensor, beta: torch.Tensor, c: int):
    """(gamma, beta) as contiguous float32 for the kernels, and the
    per-sample stride of their rows: 0 for (C,), C for (N, C)."""
    g = gamma.detach().to(torch.float32).contiguous()
    b = beta.detach().to(torch.float32).contiguous()
    return g, b, (0 if g.dim() == 1 else c)


def _count_affine(fn, gstride: int) -> None:
    fn.launches_by_affine["sample" if gstride else "channel"] += 1


def _fwd_buffers(x: torch.Tensor, plan: FwdPlan):
    """y, mean, inv, var and the scratch of one forward call."""
    n, c, h, w = x.shape
    y = torch.empty_like(x, memory_format=torch.channels_last)
    mean = torch.empty((n, c), dtype=torch.float32, device=x.device)
    inv = torch.empty_like(mean)
    var = torch.empty_like(mean)
    # chunk partials (n, G, 2, c), then each sample's (scale, shift) (n, 2, c)
    work = torch.empty((n * plan.chunks + n) * 2 * c, dtype=torch.float32,
                       device=x.device)
    # the ticket counter, then per sample its arrivals and its flag (the C
    # call zeroes them)
    counters = torch.empty(1 + 2 * n, dtype=torch.int32, device=x.device)
    return y, mean, inv, var, work, counters


def _count_fwd(route: str, mode: str, gstride: int) -> None:
    instance_norm_fwd.launches += 1
    instance_norm_fwd.launches_by_route[route] += 1
    instance_norm_fwd.launches_by_mode[mode] += 1
    _count_affine(instance_norm_fwd, gstride)


def _launch_fwd(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                plan: FwdPlan, *, eps: float, relu: bool, onepass: bool,
                capture: bool = False) -> Tuple[torch.Tensor, ...]:
    """One forward call on the card as ``plan`` says (x already checked)."""
    n, c, h, w = x.shape
    y, mean, inv, var, work, counters = _fwd_buffers(x, plan)
    g, b, gstride = _affine_rows(gamma, beta, c)
    err = _build.on_card(
        x.device, _kernels().fwd,
        x.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(),
        mean.data_ptr(), inv.data_ptr(), var.data_ptr() if capture else None,
        work.data_ptr(), counters.data_ptr(), n, h * w, h * w, c, gstride,
        plan.chunk, plan.chunks, float(eps),
        int(relu), int(onepass), int(x.dtype == torch.bfloat16), plan.vec,
        int(plan.route == "one_launch"))
    if err != 0:
        raise RuntimeError(f"instance-norm kernel launch failed: CUDA error {err} "
                           f"({plan})")
    _count_fwd(plan.route, "capture" if capture else "plain", gstride)
    return (y, mean, inv, var) if capture else (y, mean, inv)


# calls that launched a forward kernel: in all, by route ("inject": the
# blend-1 inject kernel), by affine ("channel": one (C,) row; "sample": an
# (N, C) row per sample) and by mode ("plain"; "capture": var written too;
# "inject": reference moments; the sharded forward's two passes, "stats":
# the statistics-only route, and "sharded_apply": the inject kernel with the
# global moments)
_build.counted(instance_norm_fwd, route=("one_launch", "two_launch", "inject"),
               affine=("channel", "sample"),
               mode=("plain", "capture", "inject", "stats", "sharded_apply"))


def _ref_rows(ref: torch.Tensor, n: int, c: int, name: str) -> Tuple[torch.Tensor, int]:
    """A (1, C) or (N, C) reference moment (any shape that flattens to it,
    such as (1, C, 1, 1)) as contiguous float32 (R, C) rows, and the row
    stride of the kernel: 0 for one row, C for N."""
    rows = ref.detach().to(torch.float32).reshape(-1, c) if ref.numel() % c == 0 else None
    if rows is None or rows.shape[0] not in (1, n):
        raise ValueError(f"{name} of shape {tuple(ref.shape)} is neither (1, {c}) "
                         f"nor ({n}, {c})")
    return rows.contiguous(), (0 if rows.shape[0] == 1 else c)


def instance_norm_apply_stats_reference(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    ref_mean: torch.Tensor,
    ref_var: torch.Tensor,
    *,
    blend: float = 1.0,
    relu: bool = False,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the inject kernel -> (y, own mean, own var)
    ((N, C) f32; None at blend 1, where no statistics are taken): moments
    blend * ref + (1 - blend) * own (stable), then the forward's scale and
    shift. At blend 1 with a capture's moments this is the plain forward's
    arithmetic on the same numbers."""
    n, c = x.shape[:2]
    rm, _ = _ref_rows(ref_mean, n, c, "ref_mean")
    rv, _ = _ref_rows(ref_var, n, c, "ref_var")
    xf = x.float()
    mean = var = None
    if blend == 1.0:
        m, v = rm, rv
    else:
        mean, var = _moments(xf, False)
        keep = 1.0 - blend
        m = blend * rm + keep * mean
        v = blend * rv + keep * var
    y, _ = _normalize(xf, m, v, gamma, beta, eps=eps, relu=relu)
    return y.to(x.dtype), mean, var


def instance_norm_apply_stats(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    ref_mean: torch.Tensor,
    ref_var: torch.Tensor,
    *,
    blend: float = 1.0,
    relu: bool = False,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The inject mode: instance norm + affine (+ReLU) of x with the moments
    blend * ref + (1 - blend) * x's own (stable statistics, f32), ->
    (y, own mean, own var) (None, None at blend 1). ``ref_mean``, ``ref_var``:
    (1, C) for one reference for the batch, or (N, C) (or shapes that
    flatten to them, such as a capture's (1, C, 1, 1)); gamma, beta (C,) or
    (N, C).

    A CPU tensor takes the plain version. A CUDA tensor launches, or raises:
    at blend 1 the inject kernel (one launch, no statistics pass, route
    "inject"); below it the forward's own kernel as ``plan_fwd`` routes it,
    its merge blending (one launch on "one_launch", two on "two_launch")."""
    if not 0.0 <= blend <= 1.0:
        raise ValueError(f"blend must be in [0, 1], got {blend}")
    if x.device.type == "cpu":
        return instance_norm_apply_stats_reference(
            x, gamma, beta, ref_mean, ref_var, blend=blend, relu=relu, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"instance_norm_apply_stats runs on cuda or cpu, not {x.device}")
    _check(x, gamma, beta)
    n, c, h, w = x.shape
    rm, rstride = _ref_rows(ref_mean, n, c, "ref_mean")
    rv, vstride = _ref_rows(ref_var, n, c, "ref_var")
    if rstride != vstride or rm.device != x.device or rv.device != x.device:
        raise ValueError("ref_mean and ref_var must have the same rows, on x's device")
    own = blend != 1.0
    plan = fwd_plan(x, one_launch=own)
    route = ("inject", 0) if not own else (plan.route, 1 if plan.route == "one_launch" else 2)
    y, mean, inv, var, work, counters = _fwd_buffers(x, plan)
    g, b, gstride = _affine_rows(gamma, beta, c)
    err = _build.on_card(
        x.device, _kernels().fwd_stats,
        x.data_ptr(), g.data_ptr(), b.data_ptr(), rm.data_ptr(), rv.data_ptr(),
        y.data_ptr(), mean.data_ptr(), inv.data_ptr(), var.data_ptr(),
        work.data_ptr(), counters.data_ptr(), n, h * w, h * w, c, gstride,
        rstride, plan.chunk, plan.chunks, float(eps), float(blend), float(1.0 - blend),
        int(relu), int(x.dtype == torch.bfloat16), plan.vec, route[1])
    if err != 0:
        raise RuntimeError(f"instance-norm inject kernel launch failed: CUDA error "
                           f"{err} ({plan}, blend {blend})")
    _count_fwd(route[0], "inject", gstride)
    return (y, mean, var) if own else (y, None, None)


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
    mean(g) - xhat * mean(g * xhat)); gamma, beta (C,) or (N, C). Returns
    (dx in x's dtype, per-sample dgamma (N, C) f32, per-sample dbeta (N, C)
    f32)."""
    hw = x.shape[2] * x.shape[3]
    xhat, gf = _gated(x, g, mean, inv, gamma, beta, relu)
    g_sum = gf.sum(dim=(2, 3))
    gx_sum = (gf * xhat).sum(dim=(2, 3))
    return _dx(x, xhat, gf, inv, gamma, g_sum, gx_sum, hw), gx_sum, g_sum


def _col(t: torch.Tensor) -> torch.Tensor:
    """(N, C) -> (N, C, 1, 1) float32."""
    return t.float()[:, :, None, None]


def _aff(t: torch.Tensor, c: int) -> torch.Tensor:
    """An affine (C,) -> (1, C, 1, 1), (N, C) -> (N, C, 1, 1), float32."""
    return t.float().reshape(-1, c)[:, :, None, None]


def _gated(x, g, mean, inv, gamma, beta, relu: bool):
    """The backward kernels' xhat = (x - mean) * inv and gradient g, gated
    with ``relu`` by xhat * gamma + beta > 0 in f32."""
    xhat = (x.float() - _col(mean)) * _col(inv)
    gf = g.float()
    if relu:
        gf = torch.where(xhat * _aff(gamma, x.shape[1]) + _aff(beta, x.shape[1]) > 0,
                         gf, torch.zeros((), device=gf.device))
    return xhat, gf


def _dx(x, xhat, gf, inv, gamma, g_sum, gx_sum, count):
    """dx = gamma * inv * (g - sum(g) / count - xhat * sum(g * xhat) / count)
    in x's dtype."""
    gam = _aff(gamma, x.shape[1])
    dx = (gam * _col(inv)) * (gf - _col(g_sum) / count - xhat * (_col(gx_sum) / count))
    return dx.to(x.dtype)


# one-launch backward: most bytes of x and g together a block holds, so
# that two blocks share an SM; the block's shared memory caps it first at
# most shapes (chip_smoke.py's in_bwd_budgets phase times 64, 80 and 96 KB)
_BWD_CHUNK_BYTES = 96 * 1024
_BWD_CONSTS = 6  # kBwdConsts: per-channel floats of a one-launch block


class BwdPlan(NamedTuple):
    """How one ``instance_norm_bwd`` call runs (``plan_bwd``)."""

    route: str  # "one_launch" or "two_launch"
    vec: int  # channels per access: a 16-byte pack, or 1
    chunk: int  # pixels per block
    chunks: int  # blocks per sample (G), per channel tile on two launches
    blocks: int  # blocks of a launch
    chunk_bytes: int  # bytes of x and g a block owns (its largest chunk)
    smem_bytes: int  # dynamic shared memory of a one-launch block, else 0
    capacity: int  # one-launch blocks the card holds at once


def bwd_reg_pixels(c: int, vec: int) -> int:
    """The first pixels of a one-launch backward chunk, which the block's
    threads hold in registers (bwd_reg_pixels in the source): 4 pixels a
    lane in f32 and none in bf16, where a pixel row is no more packs than a
    block has threads, else none."""
    packs = c // vec
    return (0 if vec == 8 else 4) * (_THREADS // packs) if packs <= _THREADS else 0


def bwd_smem_bytes(chunk: int, c: int, itemsize: int, vec: int) -> int:
    """Dynamic shared memory of a one-launch backward block, as the source
    sizes it: the chunk of x and of g past its register pixels (each
    rounded up to 16 bytes), two arrays of lane sums and the per-channel
    constants."""
    shared = max(chunk - bwd_reg_pixels(c, vec), 0)
    return (2 * (-(-shared * c * itemsize // 16) * 16)
            + 4 * 2 * _THREADS * vec + 4 * _BWD_CONSTS * c)


def plan_bwd(n: int, hw: int, c: int, itemsize: int, vec: int, *, sms: int,
             blocks_per_sm: int, one_launch: bool = True) -> BwdPlan:
    """The backward's kernel and chunks for n samples of hw pixels x c
    channels, on a card of ``sms`` SMs that holds ``blocks_per_sm``
    one-launch backward blocks each (``capacity`` = their product).

    One launch: chunks of whole pixel rows, the register pixels
    (``bwd_reg_pixels``) and as many more as fit _BWD_CHUNK_BYTES of x and
    g together in shared memory (and the block's shared memory
    _SMEM_LIMIT), cut smaller, down to one pixel, where the grid would
    hold fewer than two blocks per SM (or the capacity, if less). Every
    chunk of a sample has to be resident at once, so this route is taken
    iff a sample's chunks G <= capacity: x + g up to ~capacity * 96 KB
    and the register pixels (~25 MB a sample in bf16, ~33 MB in f32 on an
    H100). The blocks of a launch then run in waves of the
    capacity, and a sample whose chunks straddle two waves keeps its first
    blocks waiting through a wave, so G is raised to capacity // k, k the
    whole samples a wave holds at the fewest chunks. Otherwise (a larger
    slab, a pixel row above the budget, or ``one_launch=False``) two
    launches, element by element: G = ``_num_chunks`` per tile of 32
    channels. The sharded backward (``ShardedInstanceNormFn``) always takes
    the two-launch kernel's passes, each launched on its own: the ranks'
    sums are added between them, and the one-launch kernel merges inside
    its launch."""
    row = 2 * c * itemsize
    capacity = blocks_per_sm * sms
    fixed = bwd_smem_bytes(0, c, itemsize, vec)
    # less two roundings of a chunk up to 16 bytes
    most = (bwd_reg_pixels(c, vec)
            + min(_BWD_CHUNK_BYTES, _SMEM_LIMIT - fixed - 30) // row)
    if one_launch and most >= 1:
        g = -(-hw // most)
        fill = min(2 * sms, capacity)
        if n * g < fill:
            g = min(hw, -(-fill // n))
        if g <= capacity:
            g = capacity // (capacity // g)  # whole samples in a wave
            chunk = -(-hw // g)
            g = -(-hw // chunk)
            return BwdPlan("one_launch", vec, chunk, g, n * g, chunk * row,
                           bwd_smem_bytes(chunk, c, itemsize, vec), capacity)
    tiles = -(-c // _TILE_C)
    chunk = -(-hw // _num_chunks(n, hw, tiles))
    g = -(-hw // chunk)
    return BwdPlan("two_launch", 1, chunk, g, n * g * tiles, chunk * row, 0,
                   capacity)


def bwd_plan(x: torch.Tensor, g: torch.Tensor, *, one_launch: bool = True) -> BwdPlan:
    """The plan ``instance_norm_bwd`` follows for the CUDA tensors x and g
    (with ``one_launch=False``: the two-launch kernel's plan, for timing
    it)."""
    n, c, h, w = x.shape
    vec = pack_vec(c, x.element_size(), x.data_ptr(), g.data_ptr())
    per_sm, sms = _capacity(x.device, "bwd_capacity", int(x.dtype == torch.bfloat16), vec)
    return plan_bwd(n, h * w, c, x.element_size(), vec, sms=sms,
                    blocks_per_sm=per_sm, one_launch=one_launch)


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
    g must already be in x's dtype and layout; gamma, beta (C,) or (N, C).

    A CPU tensor takes the plain version. A CUDA tensor launches the kernel
    that ``plan_bwd`` picks, or raises: wrong dtype or layout, a failed
    build or a failed launch."""
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
    return _launch_bwd(x, g, mean, inv, gamma, beta, bwd_plan(x, g), relu=relu)


def _launch_bwd(x: torch.Tensor, g: torch.Tensor, mean: torch.Tensor,
                inv: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                plan: BwdPlan, *, relu: bool
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One backward call on the card as ``plan`` says (inputs already
    checked)."""
    n, c, h, w = x.shape
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    dgamma = torch.empty((n, c), dtype=torch.float32, device=x.device)
    dbeta = torch.empty_like(dgamma)
    # chunk partials: (n, G, 2, c) on one launch, (2, n, G, c) on two
    work = torch.empty(2 * n * plan.chunks * c, dtype=torch.float32, device=x.device)
    # the one-launch kernel's hand-off: the ticket counter, then per sample
    # its blocks that have published, then each sample's coefficients (n, 2,
    # c) (the C call zeroes them all)
    counters = torch.empty(1 + n * (1 + 2 * c), dtype=torch.int32, device=x.device)
    gm, bt, gstride = _affine_rows(gamma, beta, c)
    err = _build.on_card(
        x.device, _kernels().bwd,
        x.data_ptr(), g.data_ptr(), mean.data_ptr(), inv.data_ptr(),
        gm.data_ptr(), bt.data_ptr(), dx.data_ptr(), dgamma.data_ptr(),
        dbeta.data_ptr(), work.data_ptr(), counters.data_ptr(), n, h * w, c,
        gstride, plan.chunk, plan.chunks, int(relu),
        int(x.dtype == torch.bfloat16), plan.vec, int(plan.route == "one_launch"))
    if err != 0:
        raise RuntimeError(f"instance-norm backward kernel launch failed: CUDA "
                           f"error {err} ({plan})")
    _count_bwd(plan.route, "plain", gstride)
    return dx, dgamma, dbeta


def _count_bwd(route: str, mode: str, gstride: int) -> None:
    instance_norm_bwd.launches += 1
    instance_norm_bwd.launches_by_route[route] += 1
    instance_norm_bwd.launches_by_mode[mode] += 1
    _count_affine(instance_norm_bwd, gstride)


# calls that launched a backward kernel: in all, by route, by affine and by
# mode ("plain"; the sharded backward's two passes, "bwd_sums" and
# "bwd_apply", both on the two-launch kernel's passes)
_build.counted(instance_norm_bwd, route=("one_launch", "two_launch"),
               affine=("channel", "sample"), mode=("plain", "bwd_sums", "bwd_apply"))


class InstanceNormFn(torch.autograd.Function):
    """IN + affine (+ReLU) under autograd: forward ``instance_norm_fwd``
    with stable or ``onepass`` statistics (saving the input x, gamma, beta
    and the (mean, inv) residuals, never y), backward ``instance_norm_bwd``
    (one formula for both statistics) with the upstream gradient cast to
    x's dtype and made channels_last first. dgamma / dbeta come back per
    sample for an (N, C) affine and summed over the batch for a (C,) one."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, relu, onepass=False):
        y, mean, inv = instance_norm_fwd(x, gamma, beta, eps=eps, relu=relu,
                                         onepass=onepass)
        ctx.save_for_backward(x, gamma, beta, mean, inv)
        ctx.relu = relu
        return y

    @staticmethod
    def backward(ctx, gy):
        x, gamma, beta, mean, inv = ctx.saved_tensors
        g = gy.to(x.dtype).contiguous(memory_format=torch.channels_last)
        dx, dgn, dbn = instance_norm_bwd(x, g, mean, inv, gamma, beta,
                                         relu=ctx.relu)
        if gamma.dim() == 1:
            dgn, dbn = dgn.sum(dim=0), dbn.sum(dim=0)
        return dx, dgn.to(gamma.dtype), dbn.to(beta.dtype), None, None, None


# -- the sharded forms (one image's rows split over ranks, ops/sharded.py) ----
#
# The JAX package's ``ops/sharded.py::instance_norm_sharded`` takes global
# statistics with two ``lax.psum``s. Here each direction is two passes with a
# cross-rank exchange between them: forward, this rank's moments (the
# statistics-only route), then the ranks' moments merged (Chan's formula),
# then the inject kernel with the global moments; backward, this rank's
# gated sum(g) and sum(g * xhat), then their sum over the ranks, then dx.
# ``rows``: the first ``rows`` rows of each sample are active (an unaligned
# height's extent), the rest are left out of the statistics and written as
# relu(beta), the JAX formula's value there. The exchange goes through
# ``axis.gather`` (``parallel/mesh.py::SpaceAxis``): every rank gets every
# rank's rows exactly and merges them in rank order, so all ranks hold the
# same bits.

_units: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def _unit_affine(c: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ones, zeros) of (C,) float32 on ``device``: the statistics-only
    route's affine, which its merge reads and nothing uses."""
    key = (c, str(device))
    if key not in _units:
        _units[key] = (torch.ones(c, device=device), torch.zeros(c, device=device))
    return _units[key]


def instance_norm_moments(x: torch.Tensor, rows: Optional[int] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's (mean, biased var), each (N, C) float32 (stable), over
    the first ``rows`` rows of each sample (None: all); zeros where ``rows``
    is 0. A CPU tensor takes the plain version; a CUDA tensor launches the
    statistics-only route of the kernel ``plan_fwd`` picks for those pixels
    (x read once, no y; mode "stats"), or raises."""
    n, c, h, w = x.shape
    rows = h if rows is None else rows
    if not 0 <= rows <= h:
        raise ValueError(f"rows {rows} outside [0, {h}]")
    if rows == 0:
        zero = torch.zeros((n, c), dtype=torch.float32, device=x.device)
        return zero, zero.clone()
    if x.device.type == "cpu":
        return _moments(x[:, :, :rows].float(), False)
    if x.device.type != "cuda":
        raise ValueError(f"instance_norm_moments runs on cuda or cpu, not {x.device}")
    ones, zeros = _unit_affine(c, x.device)
    _check(x, ones, zeros)
    plan = fwd_plan(x, rows=rows, sharded=True)
    mean = torch.empty((n, c), dtype=torch.float32, device=x.device)
    inv, var = torch.empty_like(mean), torch.empty_like(mean)
    work = torch.empty((n * plan.chunks + n) * 2 * c, dtype=torch.float32,
                       device=x.device)
    counters = torch.empty(1 + 2 * n, dtype=torch.int32, device=x.device)
    err = _build.on_card(
        x.device, _kernels().fwd,
        x.data_ptr(), ones.data_ptr(), zeros.data_ptr(), None, mean.data_ptr(),
        inv.data_ptr(), var.data_ptr(), work.data_ptr(), counters.data_ptr(), n,
        rows * w, h * w, c, 0, plan.chunk, plan.chunks, 1e-5, 0, 0,
        int(x.dtype == torch.bfloat16), plan.vec, int(plan.route == "one_launch"))
    if err != 0:
        raise RuntimeError(f"instance-norm statistics kernel launch failed: CUDA "
                           f"error {err} ({plan}, rows {rows})")
    _count_fwd(plan.route, "stats", 0)
    return mean, var


def merge_moments(stats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The global (mean, biased var), each (N, C) float32, from the ranks'
    ``stats`` (R, 3, N, C) = (count, mean, var) per rank: Chan's merge in
    float64, in rank order, mean = sum c_r mean_r / C and M2 = sum (c_r
    var_r + c_r (mean_r - mean)^2). It differs from the JAX package's
    two-pass psum by rounding only."""
    st = stats.double()
    count = st[0, 0]
    for r in range(1, st.shape[0]):
        count = count + st[r, 0]
    mean = st[0, 0] * st[0, 1]
    for r in range(1, st.shape[0]):
        mean = mean + st[r, 0] * st[r, 1]
    mean = mean / count
    m2 = st[0, 0] * (st[0, 2] + (st[0, 1] - mean).square())
    for r in range(1, st.shape[0]):
        m2 = m2 + st[r, 0] * (st[r, 2] + (st[r, 1] - mean).square())
    return mean.float(), (m2 / count).float()


def _dead_rows(y: torch.Tensor, beta: torch.Tensor, rows: int, relu: bool) -> None:
    """Rows from ``rows`` on get the JAX formula's value there, (0 * inv) *
    gamma + beta, then the ReLU."""
    if rows < y.shape[2]:
        fill = _aff(beta, y.shape[1])
        if relu:
            fill = torch.relu(fill)
        y[:, :, rows:] = fill.to(y.dtype)


def instance_norm_apply_global_reference(x, gamma, beta, mean, var, *, rows=None,
                                         relu: bool = False, eps: float = 1e-5):
    """Plain PyTorch version of the sharded forward's apply pass -> (y, inv):
    the first ``rows`` rows of each sample normalized with the global (N, C)
    moments (the forward's scale and shift), the rest relu(beta)."""
    n, c, h, w = x.shape
    rows = h if rows is None else rows
    y, inv = _normalize(x[:, :, :rows].float(), mean, var, gamma, beta, eps=eps,
                        relu=relu)
    out = torch.empty_like(x)
    out[:, :, :rows] = y.to(x.dtype)
    _dead_rows(out, beta, rows, relu)
    return out, inv


def instance_norm_apply_global(x, gamma, beta, mean, var, *, rows=None,
                               relu: bool = False, eps: float = 1e-5):
    """The sharded forward's apply pass -> (y, inv (N, C) f32): normalize
    the first ``rows`` rows of each sample (None: all) with the global (N, C)
    ``mean`` and ``var`` and the (C,) or (N, C) affine (+ReLU); the other
    rows are relu(beta). A CPU tensor takes the plain version; a CUDA tensor
    launches the blend-1 inject kernel over the active rows (mode
    "sharded_apply"), or raises."""
    n, c, h, w = x.shape
    rows = h if rows is None else rows
    if x.device.type == "cpu":
        return instance_norm_apply_global_reference(
            x, gamma, beta, mean, var, rows=rows, relu=relu, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"instance_norm_apply_global runs on cuda or cpu, not {x.device}")
    _check(x, gamma, beta)
    rm, _ = _ref_rows(mean, n, c, "mean")
    rv, rstride = _ref_rows(var, n, c, "var")
    y = torch.empty_like(x, memory_format=torch.channels_last)
    if rows == 0:
        _dead_rows(y, beta, 0, relu)
        return y, torch.rsqrt(rv.expand(n, c) + eps)
    plan = fwd_plan(x, one_launch=False, rows=rows, sharded=True)
    inv = torch.empty((n, c), dtype=torch.float32, device=x.device)
    g, b, gstride = _affine_rows(gamma, beta, c)
    err = _build.on_card(
        x.device, _kernels().fwd_stats,
        x.data_ptr(), g.data_ptr(), b.data_ptr(), rm.data_ptr(), rv.data_ptr(),
        y.data_ptr(), None, inv.data_ptr(), None, None, None, n, rows * w, h * w,
        c, gstride, rstride, plan.chunk, plan.chunks, float(eps), 1.0, 0.0,
        int(relu), int(x.dtype == torch.bfloat16), plan.vec, 0)
    if err != 0:
        raise RuntimeError(f"instance-norm sharded apply launch failed: CUDA error "
                           f"{err} ({plan}, rows {rows})")
    _count_fwd("inject", "sharded_apply", gstride)
    _dead_rows(y, beta, rows, relu)
    return y, inv


def instance_norm_bwd_sums_reference(x, g, mean, inv, gamma, beta, *,
                                     relu: bool = False):
    """Plain PyTorch version of the sharded backward's first pass -> this
    rank's gated (sum(g), sum(g * xhat)), each (N, C) f32."""
    xhat, gf = _gated(x, g, mean, inv, gamma, beta, relu)
    return gf.sum(dim=(2, 3)), (gf * xhat).sum(dim=(2, 3))


def _check_bwd(x, g, mean, inv, gamma, beta) -> None:
    _check(x, gamma, beta)
    n, c = x.shape[:2]
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"g {tuple(g.shape)} {g.dtype} does not match x "
                         f"{tuple(x.shape)} {x.dtype}")
    if not g.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("the IN backward wants a channels_last contiguous g")
    for name, r in (("mean", mean), ("inv", inv)):
        if r.shape != (n, c) or r.dtype != torch.float32 or not r.is_contiguous():
            raise ValueError(f"{name} must be a contiguous ({n}, {c}) float32 tensor")


def instance_norm_bwd_sums(x, g, mean, inv, gamma, beta, *, relu: bool = False):
    """The sharded backward's first pass -> this rank's gated (sum(g),
    sum(g * xhat)), each (N, C) f32, xhat from the global (mean, inv); also
    this rank's share of (dbeta, dgamma). A CPU tensor takes the plain
    version; a CUDA tensor launches the two-launch backward's sums
    (``fnst_instance_norm_bwd_sums``, mode "bwd_sums"), or raises."""
    if x.device.type == "cpu":
        return instance_norm_bwd_sums_reference(x, g, mean, inv, gamma, beta, relu=relu)
    if x.device.type != "cuda":
        raise ValueError(f"instance_norm_bwd_sums runs on cuda or cpu, not {x.device}")
    _check_bwd(x, g, mean, inv, gamma, beta)
    n, c, h, w = x.shape
    plan = bwd_plan(x, g, one_launch=False)
    sums = torch.empty((2, n, c), dtype=torch.float32, device=x.device)
    work = torch.empty(2 * n * plan.chunks * c, dtype=torch.float32, device=x.device)
    gm, bt, gstride = _affine_rows(gamma, beta, c)
    err = _build.on_card(
        x.device, _kernels().bwd_sums,
        x.data_ptr(), g.data_ptr(), mean.data_ptr(), inv.data_ptr(), gm.data_ptr(),
        bt.data_ptr(), sums.data_ptr(), work.data_ptr(), n, h * w, c, gstride,
        plan.chunk, plan.chunks, int(relu), int(x.dtype == torch.bfloat16))
    if err != 0:
        raise RuntimeError(f"instance-norm backward sums launch failed: CUDA error "
                           f"{err} ({plan})")
    _count_bwd("two_launch", "bwd_sums", gstride)
    return sums[0], sums[1]


def instance_norm_bwd_apply_reference(x, g, mean, inv, gamma, beta, g_sum, gx_sum,
                                      count: int, *, relu: bool = False):
    """Plain PyTorch version of the sharded backward's second pass: dx from
    the global sums (``count`` pixels a sample over the ranks)."""
    xhat, gf = _gated(x, g, mean, inv, gamma, beta, relu)
    return _dx(x, xhat, gf, inv, gamma, g_sum, gx_sum, count)


def instance_norm_bwd_apply(x, g, mean, inv, gamma, beta, g_sum, gx_sum,
                            count: int, *, relu: bool = False):
    """The sharded backward's second pass -> dx = gamma * inv * (g -
    sum(g) / count - xhat * sum(g * xhat) / count), the sums (N, C) f32 over
    every rank's pixels, ``count`` pixels a sample in all. A CPU tensor takes
    the plain version; a CUDA tensor launches the two-launch backward's apply
    with the sums given (``fnst_instance_norm_bwd_apply``, mode
    "bwd_apply"), or raises."""
    if x.device.type == "cpu":
        return instance_norm_bwd_apply_reference(x, g, mean, inv, gamma, beta, g_sum,
                                                 gx_sum, count, relu=relu)
    if x.device.type != "cuda":
        raise ValueError(f"instance_norm_bwd_apply runs on cuda or cpu, not {x.device}")
    _check_bwd(x, g, mean, inv, gamma, beta)
    n, c, h, w = x.shape
    sums = torch.stack([g_sum, gx_sum]).to(device=x.device, dtype=torch.float32)
    plan = bwd_plan(x, g, one_launch=False)
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    gm, bt, gstride = _affine_rows(gamma, beta, c)
    err = _build.on_card(
        x.device, _kernels().bwd_apply,
        x.data_ptr(), g.data_ptr(), mean.data_ptr(), inv.data_ptr(), gm.data_ptr(),
        bt.data_ptr(), sums.data_ptr(), dx.data_ptr(), n, h * w, c, gstride,
        plan.chunk, plan.chunks, float(count), int(relu),
        int(x.dtype == torch.bfloat16))
    if err != 0:
        raise RuntimeError(f"instance-norm backward apply launch failed: CUDA error "
                           f"{err} ({plan})")
    _count_bwd("two_launch", "bwd_apply", gstride)
    return dx


def sharded_instance_norm_fwd(x, gamma, beta, axis, *, rows=None, eps: float = 1e-5,
                              relu: bool = False):
    """Instance norm with statistics over the whole image, whose rows are
    split over the ranks of ``axis`` (``SpaceAxis``) -> (y, mean, inv), the
    global moments (N, C) f32. ``rows``: this rank's active rows (None: all).
    Statistics pass, ``axis.gather`` of (count, mean, var), ``merge_moments``,
    apply pass."""
    n, c, h, w = x.shape
    rows = h if rows is None else rows
    mean, var = instance_norm_moments(x, rows)
    count = torch.full_like(mean, float(rows * w))
    stats = axis.gather(torch.stack([count, mean, var]).double())
    gmean, gvar = merge_moments(stats)
    y, inv = instance_norm_apply_global(x, gamma, beta, gmean, gvar, rows=rows,
                                        relu=relu, eps=eps)
    return y, gmean, inv


class ShardedInstanceNormFn(torch.autograd.Function):
    """The sharded IN under autograd: forward ``sharded_instance_norm_fwd``
    (saving x, gamma, beta and the global (mean, inv)), backward the two
    passes with the ranks' sums added between them (``axis.gather``, rank
    order, f64). dgamma / dbeta are this rank's sums only: the caller sums
    the parameter gradients over the ranks once, at the end
    (``train/spatial_step.py``); all-reducing them here too would count them
    once per rank. Per sample for an (N, C) affine, summed over the batch
    for (C,). ``rows``: this rank's active rows; ``masked``: whether any
    rank's are fewer than its slab's (an extent below the image's height),
    which the backward refuses on every rank alike: no training path masks
    rows."""

    @staticmethod
    def forward(ctx, x, gamma, beta, axis, rows, masked, eps, relu):
        y, mean, inv = sharded_instance_norm_fwd(x, gamma, beta, axis, rows=rows,
                                                 eps=eps, relu=relu)
        ctx.save_for_backward(x, gamma, beta, mean, inv)
        ctx.axis, ctx.relu, ctx.masked = axis, relu, masked
        return y

    @staticmethod
    def backward(ctx, gy):
        x, gamma, beta, mean, inv = ctx.saved_tensors
        n, c, h, w = x.shape
        if ctx.masked:
            raise NotImplementedError(
                "the sharded instance norm's backward takes no extent: only "
                "inference masks rows")
        g = gy.to(x.dtype).contiguous(memory_format=torch.channels_last)
        g_sum, gx_sum = instance_norm_bwd_sums(x, g, mean, inv, gamma, beta,
                                               relu=ctx.relu)
        ranks = ctx.axis.gather(torch.stack([g_sum, gx_sum]).double())
        total = ranks[0]
        for r in range(1, ranks.shape[0]):
            total = total + ranks[r]
        total = total.float()
        dx = instance_norm_bwd_apply(x, g, mean, inv, gamma, beta, total[0], total[1],
                                     h * w * ctx.axis.size, relu=ctx.relu)
        dgn, dbn = gx_sum, g_sum
        if gamma.dim() == 1:
            dgn, dbn = dgn.sum(dim=0), dbn.sum(dim=0)
        return dx, dgn.to(gamma.dtype), dbn.to(beta.dtype), None, None, None, None, None
