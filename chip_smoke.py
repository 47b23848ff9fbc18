#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--phases all]

Drives ``fast_neural_style_transfer_tpu_torch`` only (no JAX). It builds
the CUDA kernels from ``csrc/`` with nvcc (every source at once), and holds
each kernel against its plain PyTorch version at the shapes of the main
paths (the IN forward's and backward's two kernels each where its planner
routes: the one-launch kernel at every 256x256 site, the two-launch kernel
at a slab larger than the card holds at once; the conv dx's tap-packed
kernel at VGG conv1_1 and its tiled kernel at a k=9 conv; both IN kernels
again with per-sample (N, C) affines; the IN forward's capture and inject
modes, capture then inject at blend 1 bit for bit the plain forward). Then
it drives the main paths, each
with the kernel-launch counters (also by route, by affine and by mode) set to 0 just
before and read just after:
- serving (slice 1): the in-repo trained checkpoint against the port's own
  CPU path, concurrent HTTP requests and the inference CLI;
- training (slice 2): the training CLI for 10 steps at batch 20, 256x256,
  full width, on synthetic images, then one step on the card against the
  port's CPU path, with stable and with one-pass IN statistics;
- multi-style (slice 7): the training CLI with 4 style images (per-sample
  affines at every IN site), the checkpoint served by style index and by
  blend, the inference CLI with --style_index, and one multi-style step on
  the card against the CPU;
- video (slice 8): the video CLI on a seeded GIF with the trained
  checkpoint (frozen IN statistics: capture and inject launches), the
  frames on the card against the port's CPU path, flicker and batch time;
- AdaIN (slice 8): the AdaIN training CLI at batch 8 (the adain IN launch
  and the tap-packed conv1_1 dx each step), step times, one step on the
  card against the CPU, ArbitraryStylizer against the CPU, and
  fnst-serve --adain-decoder in its own process answering concurrent
  requests;
- export (slice 9): the export CLI on the trained checkpoint (ONNX static
  and dynamic, TorchScript, .pth, hub directory), the ONNX runtime (the IN
  forward kernel at its 14 InstanceNormalization nodes) and the archive on
  the card against the f32 Stylizer, and the AdaIN exports against
  ArbitraryStylizer;
- int8 (slice 9): the int8 Stylizer (the IN forward kernel at 14 sites)
  against its CPU path with dynamic and calibrated scales at batch 1 and 8,
  the inference CLI and fnst-serve --precision int8, and its times beside
  f32 and bf16, split by stage;
- height sharding (slice 10): the spatial inference, training and AdaIN
  paths on ranks that split an image's rows;
- data parallelism (slice 11): one launch of two data ranks (sharing the
  card over gloo where there is one card) holding the stylizer step at
  B=20 and the AdaIN step at B=8 against the one-process step, then the
  training loop with each rank's launch counts; one launch of four ranks
  (data 2 x space 2) holding the 2-D step against the unsharded one; and
  the Stylizer's replicas in one process (two on the card) against the
  unsharded Stylizer (f32, bf16, int8 with shared scales, luma), the
  inference CLI with --data_parallel and fnst-serve --data_parallel;
- tooling (slice 12): the input pipeline's f32 transport two batches ahead
  feeding a training step (against the u8 transport's), fnst-parity on
  the trained checkpoint against a reference StyleTransferNet on the CPU
  (``--reference_repo``, else a stand-in written from
  tests/torch_reference_stand_in.py), the preemption drill (SIGTERM at
  half way, resumed) and the quickstart example, each child's launches
  counted; the loss curves the drill plotted, or the skip line; the bf16
  training step's wall fed by each transport.
Last it times the kernels, their plain versions and the library ops, the
training step (single-style, 4-style and one-pass), and the IN forward and
backward at three chunk budgets each; then holds the reflect-pad kernel
bit for bit against its plain version and the F.pad route it replaced at
every pad site of the serving paths, and times it; then holds AdaAttN's
moment-attention kernel against the float32 composition at its three
sites' 512x512 shapes and its edge cases, counts its launches on a bf16
AdaAttN stylizer's served batches (3 a batch), and times it beside its
bound, its plain version and the bf16 bmm composition; then holds the
stylizer's final-conv kernel (32 -> 3, 9x9) against its plain version at
the serving and CLI shapes, counts its launch in a replayed bf16 forward
against the device trace, and times it beside its bound, its plain
version and cuDNN's bf16 conv. Every phase
prints one JSON line; any failure exits non-zero. The line before the
last lists the kernels; the last line is ``{"ok": true, "device":
{...}}``. ``--phases`` runs a subset (the build always runs), for
iterating; the kernels line needs all phases. ``--phases
int8_sensitivity`` (not in ``all``) records how far the CPU int8 path
moves when its IN outputs move one ulp, and ``--phases
train_parity_sensitivity`` how far the training step's grad norm moves
with f64 IN statistics on the CPU and with cuDNN's algorithm choice on
the card.
"""

from __future__ import annotations

import argparse
import contextlib
import http.client
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
CHECKPOINT = REPO / "evidence" / "soak40k_r5" / "style_transfer_final.pth"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
IN_FLOPS_PER_ELEMENT = 8  # stats (3) + normalize/affine (2) + ReLU, rounded up

# the IN sites of one 256x256 forward: (H, W, C, relu, sites per forward);
# a training step runs the backward of each once
SITES = [
    ("norm1", 128, 128, 64, True, 1),
    ("norm2+in1", 64, 64, 256, True, 6),
    ("in2", 64, 64, 256, False, 5),
    ("norm3", 128, 128, 64, True, 1),
    ("norm4", 256, 256, 32, True, 1),
]


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def smooth_image(h: int, w: int, seed: int) -> np.ndarray:
    """A seeded natural-looking uint8 image: coarse random colour field,
    bicubic-upsampled, plus mild noise."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, 256, (max(h // 16, 2), max(w // 16, 2), 3), dtype=np.uint8)
    img = np.asarray(Image.fromarray(coarse).resize((w, h), Image.BICUBIC), np.float32)
    img = img + rng.normal(0, 6, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean time per call between CUDA events over ``iters`` back-to-back
    calls (after warm-up)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def in_bound_ms(numel: int, itemsize: int) -> tuple:
    """Least time for one IN forward: read x once and write y once over HBM,
    against ~8 f32 operations per element; the larger of the two."""
    bytes_ms = 2 * numel * itemsize / HBM_BYTES_PER_S * 1e3
    ops_ms = IN_FLOPS_PER_ELEMENT * numel / F32_FLOPS * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def phase_device() -> dict:
    import torch

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "not available"
    print(smi_line, flush=True)
    info = {"name": name, "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "python": sys.version.split()[0], "nvidia_smi": smi_line}
    emit("device", **info)
    return info


def phase_build() -> None:
    """nvcc on every source at once, then bind each library."""
    from fast_neural_style_transfer_tpu_torch.ops import (
        _build,
        cuda_conv,
        cuda_conv_rgb,
        cuda_moment_attention,
        cuda_norm,
        cuda_pad,
    )

    t0 = time.perf_counter()
    _build.load_all(_build.SOURCES)
    cuda_norm._kernels()
    cuda_conv._kernel()
    cuda_pad._kernel()
    cuda_conv_rgb._kernel()
    cuda_moment_attention._kernel()
    seconds = time.perf_counter() - t0
    for name in _build.SOURCES:
        info = _build.build_info[name]
        ptxas = [ln.strip() for ln in info["log"].splitlines()
                 if re.search(r"registers|spill|Compiling entry|smem", ln)]
        emit("build", source=f"fast_neural_style_transfer_tpu_torch/csrc/{name}.cu",
             nvcc_seconds=info["seconds"], ptxas=ptxas)
    emit("build_total", seconds=seconds)


# a slab larger than the card holds at once: the two-launch kernel's shape
LARGE_SLAB = (2, 1024, 1024, 32, True)
# the forward kernel every IN site of the 256^2 paths takes
SITE_ROUTE = "one_launch"


def bits(t):
    """t's bits as integers, for bit-for-bit comparisons."""
    import torch

    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def phase_kernel_vs_plain(seed: int) -> float:
    """Every site shape at B=1, B=8 and B=20, and the large slab LARGE_SLAB,
    f32 and bf16, both statistics modes, against the plain version run in
    f32 on the upcast input. Each case states the planner's route, chunk
    bytes, chunks per sample (G), blocks and the card's measured capacity;
    it fails if a 256^2 site takes the two-launch route, or if a second call
    differs from the first in any bit of y, mean or inv.
    Tolerances: f32 |dy| <= 1e-4 + 1e-4|y| (the same formula, sums over up
    to 65,536 elements taken in another order); bf16 |dy| <= 1e-4 +
    2^-7|y| (rounding y to bf16 errs by half an ulp, up to 2^-8|y|; one
    ulp leaves room for the f32 differences ahead of the rounding).
    Statistics: |dmean| <= 1e-5 + 1e-4|mean|; inv relative 1e-4 (stable)
    or 1e-3 (one-pass, E[x^2] - mean^2 cancels)."""
    import torch

    from fast_neural_style_transfer_tpu_torch.ops.cuda_norm import (
        fwd_plan,
        instance_norm_fwd,
        instance_norm_fwd_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(seed)
    worst = 0.0
    shapes = sorted({(h, w, c, relu) for _, h, w, c, relu, _ in SITES})
    cases = [(n, *s, False) for s in shapes for n in (1, 8, 20)]
    cases.append((*LARGE_SLAB, True))
    for n, h, w, c, relu, large in cases:
        base = torch.randn((n, c, h, w), generator=gen, device="cuda") * 2 + 0.5
        gamma = torch.randn(c, generator=gen, device="cuda")
        beta = torch.randn(c, generator=gen, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            x = base.to(dtype).contiguous(memory_format=torch.channels_last)
            for onepass in (False, True):
                plan = fwd_plan(x, onepass=onepass)
                with torch.inference_mode():
                    y, mean, inv = instance_norm_fwd(
                        x, gamma, beta, relu=relu, onepass=onepass)
                    again = instance_norm_fwd(x, gamma, beta, relu=relu, onepass=onepass)
                    torch.cuda.synchronize()
                    y_r, mean_r, inv_r = instance_norm_fwd_reference(
                        x.float(), gamma, beta, relu=relu, onepass=onepass)
                repeatable = all(torch.equal(bits(a), bits(b))
                                 for a, b in zip((y, mean, inv), again))
                rtol_y = 1e-4 if dtype == torch.float32 else 2.0 ** -7
                dy = (y.float() - y_r).abs()
                y_over = (dy / (1e-4 + rtol_y * y_r.abs())).max().item()
                m_over = ((mean - mean_r).abs()
                          / (1e-5 + 1e-4 * mean_r.abs())).max().item()
                inv_rel = ((inv - inv_r).abs() / inv_r).max().item()
                inv_tol = 1e-3 if onepass else 1e-4
                max_abs = dy.max().item()
                worst = max(worst, max_abs)
                route_ok = large or plan.route == SITE_ROUTE
                ok = (y_over <= 1 and m_over <= 1 and inv_rel <= inv_tol
                      and repeatable and route_ok)
                emit("kernel_vs_plain", shape=[n, h, w, c], relu=relu,
                     dtype=str(dtype).replace("torch.", ""), onepass=onepass,
                     route=plan.route, chunk_pixels=plan.chunk,
                     chunk_bytes=plan.chunk_bytes, chunks_per_sample=plan.chunks,
                     blocks=plan.blocks, smem_bytes=plan.smem_bytes,
                     capacity=plan.capacity, y_max_abs_err=max_abs,
                     y_max_rel_err=(dy / y_r.abs().clamp_min(1.0)).max().item(),
                     y_rtol=rtol_y, y_atol=1e-4, y_err_over_tol=y_over,
                     mean_err_over_tol=m_over, inv_max_rel_err=inv_rel,
                     inv_rtol=inv_tol, bitwise_repeatable=repeatable, ok=ok)
                if not ok:
                    fail(f"kernel disagrees with plain, repeats with other bits or "
                         f"takes the wrong route at {[n, h, w, c]} {dtype} "
                         f"onepass={onepass} ({plan.route})")
                del y, mean, inv, again, y_r, mean_r, inv_r
    return worst


def in_bwd_scales(x, g, mean, inv, gamma, beta, relu):
    """Sums of the absolute values of the terms the IN backward adds: a
    sum taken in another order errs by at most (terms) * 2^-24 of it, so
    these scale the tolerances. -> (per-element dx scale, per-(n, c) dgamma
    scale, per-(n, c) dbeta scale)."""
    import torch

    col = lambda t: t[:, :, None, None]
    aff = lambda t: t.reshape(-1, t.shape[-1])[:, :, None, None]  # (C,) or (N, C)
    xh = (x.float() - col(mean)) * col(inv)
    gf = g.float()
    if relu:
        gf = torch.where(xh * aff(gamma) + aff(beta) > 0, gf,
                         torch.zeros((), device=gf.device))
    a = gf.abs().mean(dim=(2, 3))
    b = (gf * xh).abs().mean(dim=(2, 3))
    dx_scale = (aff(gamma) * col(inv)).abs() * (gf.abs() + col(a) + xh.abs() * col(b))
    return dx_scale, (gf * xh).abs().sum(dim=(2, 3)), gf.abs().sum(dim=(2, 3))


def over_tol(err, tol) -> float:
    """max of err / tol (<= 1 passes)."""
    return (err / tol.clamp_min(1e-30)).max().item()


def in_bwd_chain(plan, c: int) -> int:
    """The longest chain of f32 adds in a row behind one of the IN
    backward's sums under ``plan``: the terms one thread adds, the levels
    of its lane tree, the chunk partials one merge lane adds, the levels of
    the merge's tree (one launch; two launches: 8 pixel lanes and 8 chunk
    lanes, each folded in 7 adds in a row)."""
    if plan.route == "two_launch":
        return -(-plan.chunk // 8) + 7 + -(-plan.chunks // 8) + 7
    packs = c // plan.vec
    lanes = max(1, 256 // packs)
    per = 1  # the merge's slice of channels
    while per * plan.chunks < c:
        per *= 2
    merge_lanes = max(1, 256 // min(per, 256))
    return (-(-plan.chunk // lanes) + lanes.bit_length()
            + -(-plan.chunks // merge_lanes) + merge_lanes.bit_length())


def phase_in_bwd_vs_plain(seed: int) -> float:
    """IN backward kernel against its plain version (the same formula in
    f32 on the upcast inputs), with (mean, inv) from the forward kernel: the
    three site shapes with ReLU on and off, B=1 and B=20, f32 and bf16, on
    the one-launch kernel (asserted), and the large slab LARGE_SLAB (ReLU
    on) on the two-launch kernel (asserted). Each case states the planner's
    plan and repeats: a second call must give the same bits of dx, dgamma
    and dbeta.
    Tolerances: |ddx| <= r_s * S + r|dx| with S the per-element sum of
    absolute terms (in_bwd_scales). A sum whose adds run in a chain of L
    errs by <= L * 2^-24 of its sum of absolute terms, and an error e in
    the two sums moves dx by <= e * S. L is in_bwd_chain(plan): on the one
    launch at most 32 at these shapes (<= 16 pixels a thread, its lane
    tree, a merge lane's few chunk partials, the merge's tree), so 1.9e-6 *
    S; on the two launches at the large slab 2,070 (2,048 pixels a
    thread), so 1.2e-4 * S. r_s = max(1e-4, 2 L 2^-24): as much again for
    the plain version's
    own sums; 1e-4 at every site, 2.5e-4 at the large slab. r = 0 in f32
    and 2^-7 in bf16 (dx rounded to bf16 errs by half an ulp, up to 2^-8
    |dx|; one ulp leaves room for the f32 differences ahead of the
    rounding). |ddgamma| and |ddbeta| <= r_s of their sums of absolute
    terms. The ReLU masks are bitwise equal (the kernel rounds each
    operation of xhat * gamma + beta on its own)."""
    import torch

    from fast_neural_style_transfer_tpu_torch.ops.cuda_norm import (
        bwd_plan,
        instance_norm_bwd,
        instance_norm_bwd_reference,
        instance_norm_fwd,
    )

    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    worst = 0.0
    shapes = sorted({(h, w, c) for _, h, w, c, _, _ in SITES})
    cases = [(n, h, w, c, (False, True), SITE_ROUTE) for h, w, c in shapes
             for n in (1, 20)]
    n, h, w, c, _ = LARGE_SLAB
    cases.append((n, h, w, c, (True,), "two_launch"))
    for n, h, w, c, relus, route in cases:
        base = torch.randn((n, c, h, w), generator=gen, device="cuda") * 2 + 0.5
        gbase = torch.randn((n, c, h, w), generator=gen, device="cuda")
        gamma = torch.randn(c, generator=gen, device="cuda")
        beta = torch.randn(c, generator=gen, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            x = base.to(dtype).contiguous(memory_format=torch.channels_last)
            g = gbase.to(dtype).contiguous(memory_format=torch.channels_last)
            plan = bwd_plan(x, g)
            r_s = max(1e-4, 2 * in_bwd_chain(plan, c) * 2.0 ** -24)
            with torch.inference_mode():
                _, mean, inv = instance_norm_fwd(x, gamma, beta)
            for relu in relus:
                with torch.inference_mode():
                    dx, dgn, dbn = instance_norm_bwd(x, g, mean, inv, gamma, beta,
                                                     relu=relu)
                    again = instance_norm_bwd(x, g, mean, inv, gamma, beta, relu=relu)
                    torch.cuda.synchronize()
                    dx_r, dgn_r, dbn_r = instance_norm_bwd_reference(
                        x.float(), g.float(), mean, inv, gamma, beta, relu=relu)
                    sx, sg, sb = in_bwd_scales(x, g, mean, inv, gamma, beta, relu)
                repeatable = all(torch.equal(bits(a), bits(b))
                                 for a, b in zip((dx, dgn, dbn), again))
                r = 0.0 if dtype == torch.float32 else 2.0 ** -7
                ddx = (dx.float() - dx_r).abs()
                dx_over = over_tol(ddx, r_s * sx + r * dx_r.abs())
                dg_over = over_tol((dgn - dgn_r).abs(), r_s * sg)
                db_over = over_tol((dbn - dbn_r).abs(), r_s * sb)
                max_abs = ddx.max().item()
                worst = max(worst, max_abs)
                ok = (max(dx_over, dg_over, db_over) <= 1 and repeatable
                      and plan.route == route)
                emit("in_bwd_vs_plain", shape=[n, h, w, c], relu=relu,
                     dtype=str(dtype).replace("torch.", ""), route=plan.route,
                     vec=plan.vec, chunk_pixels=plan.chunk, chunk_bytes=plan.chunk_bytes,
                     chunks_per_sample=plan.chunks, blocks=plan.blocks,
                     smem_bytes=plan.smem_bytes, capacity=plan.capacity,
                     add_chain=in_bwd_chain(plan, c), sum_rtol=r_s,
                     dx_max_abs_err=max_abs,
                     dx_max=dx_r.abs().max().item(), dx_err_over_tol=dx_over,
                     dgamma_max_abs_err=(dgn - dgn_r).abs().max().item(),
                     dgamma_err_over_tol=dg_over,
                     dbeta_max_abs_err=(dbn - dbn_r).abs().max().item(),
                     dbeta_err_over_tol=db_over, bitwise_repeatable=repeatable, ok=ok)
                if not ok:
                    fail(f"IN backward kernel disagrees with plain, repeats with "
                         f"other bits or takes the wrong route at {[n, h, w, c]} "
                         f"{dtype} relu={relu} ({plan.route})")
                del dx, dgn, dbn, again, dx_r, dgn_r, dbn_r, sx, sg, sb
    return worst


# conv backward cases: (N, H, W, C_in, k, route of dx-only). VGG conv1_1
# (64 -> 3, k3) at 256x256 with B=1, B=8 (AdaIN training) and B=20
# (training), and 200x300 with B=2 (ragged strips and tiles, outside the TPU
# kernel's gate), on the tap-packed kernel; a k=9, C_in=1 conv (k*k*C_in =
# 81 > 32) on the tiled one
CONV_CASES = [(1, 256, 256, 3, 3, "tap_packed"), (8, 256, 256, 3, 3, "tap_packed"),
              (20, 256, 256, 3, 3, "tap_packed"), (2, 200, 300, 3, 3, "tap_packed"),
              (2, 128, 160, 1, 9, "tiled")]


def phase_conv_bwd_vs_plain(seed: int) -> float:
    """conv backward kernels against their plain version (shifted sums in
    f32 on the upcast inputs) at CONV_CASES, f32 and bf16: dx-only on the
    route plan_conv_dx picks (asserted; each case called twice, and the
    second call must give the same bits), and full mode (dx, dw, db) on the
    tiled kernel. Each case states its plan; a tap-packed plan's shared
    memory must equal the source's. Tolerances: each output is a sum (dx:
    k*k*64 terms a pixel; dw, db: N*H*W terms an entry); a sum in another
    order errs by at most (terms) * 2^-24 of its sum of absolute terms S,
    in practice by ~sqrt(terms) times less, and 3xTF32 products by ~2^-21
    of S, so |d| <= 1e-4 * S, plus 2^-7 |dx| in bf16 (one ulp: dx rounded
    to bf16 errs by up to 2^-8 |dx|). -> the largest |ddx| of each case,
    by (N, H, W, C_in, k)."""
    import torch

    from fast_neural_style_transfer_tpu_torch.ops.cuda_conv import (
        _kernel,
        conv2d_same_bwd,
        conv2d_same_bwd_reference,
        conv2d_same_dx,
        conv2d_same_dx_reference,
        conv_dx_plan,
    )

    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    worst = {}
    for n, h, w, ci, k, route in CONV_CASES:
        w32 = torch.randn((64, ci, k, k), generator=gen, device="cuda") * 0.1
        gbase = torch.randn((n, 64, h, w), generator=gen, device="cuda")
        xbase = torch.randn((n, ci, h, w), generator=gen, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            g = gbase.to(dtype).contiguous(memory_format=torch.channels_last)
            x = xbase.to(dtype).contiguous(memory_format=torch.channels_last)
            wt = w32.to(dtype)
            plan = conv_dx_plan(g, wt)
            bf16 = int(dtype == torch.bfloat16)
            smem_ok = (plan.route != "tap_packed"
                       or plan.smem_bytes == _kernel().dx_smem(k, ci, bf16))
            with torch.inference_mode():
                dx_r, dw_r, db_r = conv2d_same_bwd_reference(g.float(), x.float(), wt.float())
                _, sw, sb = conv2d_same_bwd_reference(g.float().abs(), x.float().abs(),
                                                      wt.float().abs())
                sx = conv2d_same_dx_reference(g.float().abs(), wt.float().abs())
            r = 0.0 if dtype == torch.float32 else 2.0 ** -7
            for mode in ("dx", "full"):
                repeatable = True
                with torch.inference_mode():
                    if mode == "dx":
                        dx = conv2d_same_dx(g, wt)
                        again = conv2d_same_dx(g, wt)
                        torch.cuda.synchronize()
                        repeatable = torch.equal(bits(dx), bits(again))
                        del again
                    else:
                        dx, dw, db = conv2d_same_bwd(g, x, wt)
                    torch.cuda.synchronize()
                ddx = (dx.float() - dx_r).abs()
                fields = {"dx_max_abs_err": ddx.max().item(),
                          "dx_max": dx_r.abs().max().item(),
                          "dx_err_over_tol": over_tol(ddx, 1e-4 * sx + r * dx_r.abs())}
                if mode == "full":
                    fields.update(
                        dw_max_abs_err=(dw - dw_r).abs().max().item(),
                        dw_err_over_tol=over_tol((dw - dw_r).abs(), 1e-4 * sw),
                        db_max_abs_err=(db - db_r).abs().max().item(),
                        db_err_over_tol=over_tol((db - db_r).abs(), 1e-4 * sb))
                worst[n, h, w, ci, k] = max(worst.get((n, h, w, ci, k), 0.0),
                                            fields["dx_max_abs_err"])
                kernel = plan.route if mode == "dx" else "tiled"
                ok = (dx.shape == x.shape and dx.dtype == dtype and repeatable
                      and plan.route == route and smem_ok
                      and max(v for k_, v in fields.items() if k_.endswith("over_tol")) <= 1)
                emit("conv_bwd_vs_plain", shape=[n, h, w], c_in=ci, c_out=64, k=k,
                     dtype=str(dtype).replace("torch.", ""), mode=mode, route=kernel,
                     plan=plan._asdict() if mode == "dx" else None,
                     bitwise_repeatable=repeatable if mode == "dx" else None,
                     ok=ok, **fields)
                if not ok:
                    fail(f"conv backward kernel disagrees with plain, repeats with "
                         f"other bits or takes the wrong route at {[n, h, w]} k={k} "
                         f"C_in={ci} {dtype} {mode} ({plan.route})")
            del g, x, dx, dx_r, sx
    return worst


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch counts (``ops/_build.py::COUNTED``:
    the IN forward's and backward's, the conv backward's and the reflect
    pad's), in all, by route, by affine and by mode, to 0."""
    from fast_neural_style_transfer_tpu_torch.ops import conv, cuda_norm  # noqa: F401 (they count)
    from fast_neural_style_transfer_tpu_torch.ops._build import COUNTED

    for fn in COUNTED:
        for name, value in list(vars(fn).items()):
            if name.startswith("launches"):
                setattr(fn, name, dict.fromkeys(value, 0) if isinstance(value, dict) else 0)


def nonzero(counts: dict) -> dict:
    """The entries of a count dict that are not 0."""
    return {k: v for k, v in counts.items() if v}


def phase_affine_vs_plain(seed: int) -> tuple:
    """Both IN kernels with per-sample (N, C) gamma and beta (multi-style
    training), against their plain versions: the site shapes at N = 8 and
    20 on the one-launch kernels and LARGE_SLAB on the two-launch kernels
    (routes asserted), ReLU on and off, f32 and bf16; the forward in both
    statistics modes, the backward on the forward's (mean, inv). The rows
    differ and hold negative entries, so the ReLU gate flips per sample.
    Each call runs twice and must repeat bit for bit; each is counted as a
    "sample" launch. Tolerances: those of phase_kernel_vs_plain (forward)
    and phase_in_bwd_vs_plain (backward). Then the same shapes with (N, C)
    rows that all equal a (C,) vector: output bit-identical to the (C,)
    call, both directions (f32 and bf16, ReLU on). -> the largest |dy| and
    the largest |ddx|."""
    import torch

    from fast_neural_style_transfer_tpu_torch.ops.cuda_norm import (
        bwd_plan,
        fwd_plan,
        instance_norm_bwd,
        instance_norm_bwd_reference,
        instance_norm_fwd,
        instance_norm_fwd_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(seed + 6)
    worst = {"fwd": 0.0, "bwd": 0.0}
    shapes = sorted({(h, w, c) for _, h, w, c, _, _ in SITES})
    cases = [(n, h, w, c, SITE_ROUTE) for h, w, c in shapes for n in (8, 20)]
    cases.append((*LARGE_SLAB[:4], "two_launch"))
    for n, h, w, c, route in cases:
        base = torch.randn((n, c, h, w), generator=gen, device="cuda") * 2 + 0.5
        gbase = torch.randn((n, c, h, w), generator=gen, device="cuda")
        g_rows = torch.randn((n, c), generator=gen, device="cuda")
        b_rows = torch.randn((n, c), generator=gen, device="cuda")
        gamma = torch.randn(c, generator=gen, device="cuda")
        beta = torch.randn(c, generator=gen, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            x = base.to(dtype).contiguous(memory_format=torch.channels_last)
            g = gbase.to(dtype).contiguous(memory_format=torch.channels_last)
            bplan = bwd_plan(x, g)
            r_s = max(1e-4, 2 * in_bwd_chain(bplan, c) * 2.0 ** -24)
            r = 0.0 if dtype == torch.float32 else 2.0 ** -7
            dname = str(dtype).replace("torch.", "")
            for relu in (False, True):
                for onepass in (False, True):
                    fplan = fwd_plan(x, onepass=onepass)
                    before = instance_norm_fwd.launches_by_affine["sample"]
                    with torch.inference_mode():
                        y, mean, inv = instance_norm_fwd(x, g_rows, b_rows, relu=relu,
                                                         onepass=onepass)
                        again = instance_norm_fwd(x, g_rows, b_rows, relu=relu,
                                                  onepass=onepass)
                        torch.cuda.synchronize()
                        y_r, mean_r, inv_r = instance_norm_fwd_reference(
                            x.float(), g_rows, b_rows, relu=relu, onepass=onepass)
                    repeatable = all(torch.equal(bits(a), bits(b))
                                     for a, b in zip((y, mean, inv), again))
                    rtol_y = 1e-4 if dtype == torch.float32 else 2.0 ** -7
                    dy = (y.float() - y_r).abs()
                    y_over = (dy / (1e-4 + rtol_y * y_r.abs())).max().item()
                    inv_rel = ((inv - inv_r).abs() / inv_r).max().item()
                    inv_tol = 1e-3 if onepass else 1e-4
                    counted = instance_norm_fwd.launches_by_affine["sample"] - before
                    worst["fwd"] = max(worst["fwd"], dy.max().item())
                    ok = (y_over <= 1 and inv_rel <= inv_tol and repeatable
                          and fplan.route == route and counted == 2)
                    emit("affine_vs_plain", direction="fwd", affine="sample",
                         shape=[n, h, w, c], relu=relu, dtype=dname, onepass=onepass,
                         route=fplan.route, chunks_per_sample=fplan.chunks,
                         y_max_abs_err=dy.max().item(), y_err_over_tol=y_over,
                         inv_max_rel_err=inv_rel, inv_rtol=inv_tol,
                         bitwise_repeatable=repeatable, sample_launches=counted, ok=ok)
                    if not ok:
                        fail(f"IN forward with per-sample affines failed at "
                             f"{[n, h, w, c]} {dtype} relu={relu} onepass={onepass}")
                    del y, again, y_r, mean_r, inv_r
                    if onepass:
                        continue
                    before = instance_norm_bwd.launches_by_affine["sample"]
                    with torch.inference_mode():
                        dx, dgn, dbn = instance_norm_bwd(x, g, mean, inv, g_rows, b_rows,
                                                         relu=relu)
                        again = instance_norm_bwd(x, g, mean, inv, g_rows, b_rows,
                                                  relu=relu)
                        torch.cuda.synchronize()
                        dx_r, dgn_r, dbn_r = instance_norm_bwd_reference(
                            x.float(), g.float(), mean, inv, g_rows, b_rows, relu=relu)
                        sx, sg, sb = in_bwd_scales(x, g, mean, inv, g_rows, b_rows, relu)
                    repeatable = all(torch.equal(bits(a), bits(b))
                                     for a, b in zip((dx, dgn, dbn), again))
                    ddx = (dx.float() - dx_r).abs()
                    dx_over = over_tol(ddx, r_s * sx + r * dx_r.abs())
                    dg_over = over_tol((dgn - dgn_r).abs(), r_s * sg)
                    db_over = over_tol((dbn - dbn_r).abs(), r_s * sb)
                    counted = instance_norm_bwd.launches_by_affine["sample"] - before
                    worst["bwd"] = max(worst["bwd"], ddx.max().item())
                    ok = (max(dx_over, dg_over, db_over) <= 1 and repeatable
                          and bplan.route == route and counted == 2)
                    emit("affine_vs_plain", direction="bwd", affine="sample",
                         shape=[n, h, w, c], relu=relu, dtype=dname, route=bplan.route,
                         chunks_per_sample=bplan.chunks, sum_rtol=r_s,
                         dx_max_abs_err=ddx.max().item(), dx_err_over_tol=dx_over,
                         dgamma_err_over_tol=dg_over, dbeta_err_over_tol=db_over,
                         bitwise_repeatable=repeatable, sample_launches=counted, ok=ok)
                    if not ok:
                        fail(f"IN backward with per-sample affines failed at "
                             f"{[n, h, w, c]} {dtype} relu={relu}")
                    del mean, inv, dx, dgn, dbn, again, dx_r, dgn_r, dbn_r, sx, sg, sb
            # (N, C) rows equal to a (C,) vector: the (C,) call's bits
            same_g = gamma.expand(n, c).contiguous()
            same_b = beta.expand(n, c).contiguous()
            with torch.inference_mode():
                outs = {}
                for kind, (ga, be) in (("rows", (same_g, same_b)), ("channel", (gamma, beta))):
                    fwd = instance_norm_fwd(x, ga, be, relu=True)
                    outs[kind] = fwd + instance_norm_bwd(x, g, fwd[1], fwd[2], ga, be,
                                                         relu=True)
                torch.cuda.synchronize()
            same = all(torch.equal(bits(a), bits(b))
                       for a, b in zip(outs["rows"], outs["channel"]))
            emit("affine_vs_plain", direction="fwd+bwd", affine="equal rows vs channel",
                 shape=[n, h, w, c], relu=True, dtype=dname, bit_identical=same, ok=same)
            if not same:
                fail(f"equal (N, C) rows differ from the (C,) call at {[n, h, w, c]} "
                     f"{dtype}")
            del outs, x, g
    return worst["fwd"], worst["bwd"]


def phase_trained_weights() -> None:
    """Trained .pth on the card (f32, bf16) against the port's CPU f32 path:
    f32 max |du8| <= 1; bf16 SSIM >= 0.98; 14 kernel launches per forward."""
    from fast_neural_style_transfer_tpu_torch.infer import Stylizer
    from fast_neural_style_transfer_tpu_torch.models import NUM_IN_SITES
    from fast_neural_style_transfer_tpu_torch.ops.cuda_norm import instance_norm_fwd
    from fast_neural_style_transfer_tpu_torch.utils.ssim import ssim

    params = Stylizer.load_params(str(CHECKPOINT))
    cpu = Stylizer(params, device="cpu", precision="f32")
    for precision in ("f32", "bf16"):
        card = Stylizer(params, precision=precision)
        for i, (h, w) in enumerate(((256, 256), (200, 300))):
            img = smooth_image(h, w, seed=100 + i)
            want = cpu.stylize_u8(img)
            before = instance_norm_fwd.launches
            got = card.stylize_u8(img)
            launches = instance_norm_fwd.launches - before
            du8 = int(np.abs(got.astype(int) - want.astype(int)).max())
            score = ssim(got / 255.0, want / 255.0)
            ok = (got.shape == (h, w, 3) and launches == NUM_IN_SITES
                  and (du8 <= 1 if precision == "f32" else score >= 0.98))
            emit("trained_weights", precision=precision, size=[h, w],
                 max_abs_du8=du8, ssim=score, launches_per_forward=launches,
                 criterion="max|du8|<=1" if precision == "f32" else "ssim>=0.98",
                 ok=ok)
            if not ok:
                fail(f"trained-weights check failed ({precision}, {h}x{w})")


def replay_kernels(sty, x) -> dict:
    """One forward of ``sty`` at ``x``'s key, which it has captured, under
    torch.profiler: the ``in_fwd_*``, reflect-pad and final-conv kernels in
    the device trace, against those the launch counters it moved say (an IN
    launch is two kernels on the two-launch route, one on the others)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fast_neural_style_transfer_tpu_torch.ops.conv import reflect_pad_hw
    from fast_neural_style_transfer_tpu_torch.ops.cuda_conv_rgb import conv_to_rgb
    from fast_neural_style_transfer_tpu_torch.ops.cuda_norm import instance_norm_fwd

    replays = sty.graph_replays
    routes, pads = dict(instance_norm_fwd.launches_by_route), reflect_pad_hw.launches
    rgbs = conv_to_rgb.launches
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sty.stylize_u8(x)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    moved = {r: n - routes[r] for r, n in instance_norm_fwd.launches_by_route.items()}
    return {"replayed": sty.graph_replays - replays,
            "traced_in_fwd": sum(bool(re.search(r"\bin_fwd_", n)) for n in names),
            "counted_in_fwd": moved["one_launch"] + 2 * moved["two_launch"] + moved["inject"],
            "traced_pads": sum(bool(re.search(r"\bpad_(pixels|gather)\b", n)) for n in names),
            "counted_pads": reflect_pad_hw.launches - pads,
            "traced_rgb": sum(bool(re.search(r"\bconv_to_rgb_kernel\b", n)) for n in names),
            "counted_rgb": conv_to_rgb.launches - rgbs}


def phase_serving() -> dict:
    """The main path: the port's server (bf16, the trained checkpoint, the
    CLI's batching defaults) on 127.0.0.1:0 answers two bursts of 16
    concurrent requests and 8 sequential ones, then the inference CLI
    stylizes one file. Launch counters are set to 0 just before and read
    just after: 14 IN launches, 13 reflect pads and one final conv a
    forward, the server's forwards replaying the CUDA graphs its warm-up
    captured. Then one more replay under torch.profiler: its ``in_fwd_*``,
    pad and final-conv kernels in the device trace are those its counters
    add. Requests go through http.client: the first urllib burst in
    a process pays a client-side start-up cost of its own."""
    import torch
    from PIL import Image

    from fast_neural_style_transfer_tpu_torch.cli import begin_inference
    from fast_neural_style_transfer_tpu_torch.infer import Stylizer
    from fast_neural_style_transfer_tpu_torch.models import NUM_IN_SITES
    from fast_neural_style_transfer_tpu_torch.ops.conv import reflect_pad_hw
    from fast_neural_style_transfer_tpu_torch.ops.cuda_conv_rgb import conv_to_rgb
    from fast_neural_style_transfer_tpu_torch.ops.cuda_norm import instance_norm_fwd
    from fast_neural_style_transfer_tpu_torch.serve import make_server

    sty = Stylizer.from_checkpoint(str(CHECKPOINT), precision="bf16")
    t0 = time.perf_counter()
    srv = make_server(sty.stylize_u8, family="flagship", device=sty.device,
                      port=0, max_batch=8, max_wait_ms=5.0, warm_size=256)
    emit("serving_warm_up", batch_sizes=[1, 8], seconds=time.perf_counter() - t0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    port = srv.server_address[1]
    base = f"http://127.0.0.1:{port}"
    buf = io.BytesIO()
    Image.fromarray(smooth_image(256, 256, seed=7)).save(buf, format="JPEG", quality=95)
    body = buf.getvalue()

    def post(_):
        t0 = time.perf_counter()
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        try:
            conn.connect()
            t_conn = time.perf_counter()
            conn.request("POST", "/stylize", body=body,
                         headers={"Content-Type": "image/jpeg"})
            resp = conn.getresponse()
            t_headers = time.perf_counter()
            status, reply = resp.status, resp.read()
        finally:
            conn.close()
        size = Image.open(io.BytesIO(reply)).size
        return (status, size, (time.perf_counter() - t0) * 1e3,
                (t_headers - t0) * 1e3, (t_conn - t0) * 1e3)

    def burst_stats(replies):
        with urllib.request.urlopen(f"{base}/stats", timeout=60) as r:
            server_p50 = json.load(r)["latency_p50_ms"]
        return {"p50_ms": float(np.median([r[2] for r in replies])),
                "max_ms": float(max(r[2] for r in replies)),
                "headers_p50_ms": float(np.median([r[3] for r in replies])),
                "connect_p50_ms": float(np.median([r[4] for r in replies])),
                "server_p50_ms_so_far": server_p50}

    reset_launch_counts()
    try:
        bursts, burst_info = [], []
        for _ in range(2):
            with ThreadPoolExecutor(max_workers=16) as pool:
                bursts.append(list(pool.map(post, range(16))))
            burst_info.append(burst_stats(bursts[-1]))
        burst = bursts[0] + bursts[1]
        seq = [post(i) for i in range(8)]
        with urllib.request.urlopen(f"{base}/stats", timeout=60) as r:
            stats = json.load(r)
        with urllib.request.urlopen(f"{base}/healthz", timeout=60) as r:
            health = json.load(r)
        with tempfile.TemporaryDirectory() as tmp:
            src = os.path.join(tmp, "content.jpg")
            Image.fromarray(smooth_image(240, 320, seed=8)).save(src, quality=95)
            begin_inference.main(["--model_path", str(CHECKPOINT),
                                  "--content_image", src, "--output_dir", tmp,
                                  "--output_name", "out.png",
                                  "--precision", "bf16"])
            cli_size = Image.open(os.path.join(tmp, "out.png")).size
    finally:
        srv.shutdown()
        thread.join(timeout=30)
    launches = instance_norm_fwd.launches
    by_route = dict(instance_norm_fwd.launches_by_route)
    pad_launches = reflect_pad_hw.launches
    rgb_launches = conv_to_rgb.launches
    forwards = stats["batches"] + 1  # server batches + the CLI's one forward
    graphs = {"captures": sty.graph_captures, "replays": sty.graph_replays,
              "replay_kernels": replay_kernels(sty, np.zeros((1, 256, 256, 3), np.uint8))}
    rk = graphs["replay_kernels"]
    result = {
        "http_status": sorted({r[0] for r in burst + seq}),
        "burst1": burst_info[0], "burst2": burst_info[1],
        "sequential_p50_ms": float(np.median([r[2] for r in seq])),
        "server_latency_p50_ms": stats["latency_p50_ms"],
        "mean_batch_occupancy": stats["mean_batch_occupancy"],
        "batches": stats["batches"], "healthz_device": health["device"],
        "cli_output_size": list(cli_size), "launches": launches,
        "launches_by_route": by_route, "expected_launches": NUM_IN_SITES * forwards,
        "pad_launches": pad_launches, "expected_pad_launches": STYLIZER_PADS * forwards,
        "rgb_launches": rgb_launches,
        "graphs": graphs,
    }
    ok = (all(r[0] == 200 and r[1] == (256, 256) for r in burst + seq)
          and stats["mean_batch_occupancy"] > 1
          and health["device"] == torch.cuda.get_device_name(0)
          and cli_size == (320, 240) and launches == NUM_IN_SITES * forwards
          and by_route[SITE_ROUTE] == launches
          and pad_launches == STYLIZER_PADS * forwards and rgb_launches == forwards
          and graphs["replays"] > 0 and rk["replayed"] == 1
          and rk["traced_in_fwd"] == rk["counted_in_fwd"] == NUM_IN_SITES
          and rk["traced_pads"] == rk["counted_pads"] == STYLIZER_PADS
          and rk["traced_rgb"] == rk["counted_rgb"] == 1)
    emit("serving", ok=ok, **result)
    if not ok or launches == 0:
        fail("serving phase")
    return result


TRAIN_STEPS = 10
TRAIN_BATCH = 20  # the training CLI's default
# reflect pads a forward: the stylizer's (conv1, conv2, the 10 res-block
# convs, final_conv) and the AdaIN decoder's (ReLUs and upsamples read through)
STYLIZER_PADS = 13
DECODER_PADS = 9


def phase_training(seed: int) -> dict:
    """The training main path: the port's training CLI on the card for
    TRAIN_STEPS steps at batch 20, 256x256, f32 (the CLI's defaults), full
    width, the seeded random VGG (no ImageNet weights exist here), on 40
    synthetic JPEGs and a synthetic style image. Launch counters are set to
    0 just before and read just after: 14 IN forwards and 14 IN backwards
    (all on the one-launch kernels), one conv1_1 dx per step (all on
    the tap-packed kernel) and one reflect-pad launch per step (conv1's pad
    of the image batch, which needs no gradient). Every
    logged loss must be finite with no
    skipped step, a checkpoint and style_transfer_final.npz must be
    written, and the port's Stylizer must stylize an image on the card with
    that .npz."""
    import torch
    from PIL import Image

    from fast_neural_style_transfer_tpu_torch.cli import begin_training
    from fast_neural_style_transfer_tpu_torch.infer import Stylizer
    from fast_neural_style_transfer_tpu_torch.models import NUM_IN_SITES
    from fast_neural_style_transfer_tpu_torch.ops.conv import reflect_pad_hw
    from fast_neural_style_transfer_tpu_torch.ops.cuda_conv import (
        conv2d_same_bwd,
        conv2d_same_dx,
    )
    from fast_neural_style_transfer_tpu_torch.ops.cuda_norm import (
        instance_norm_bwd,
        instance_norm_fwd,
    )

    counters = {"instance_norm_fwd": instance_norm_fwd,
                "instance_norm_bwd": instance_norm_bwd,
                "conv2d_same_dx": conv2d_same_dx, "conv2d_same_bwd": conv2d_same_bwd,
                "reflect_pad": reflect_pad_hw}
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        os.makedirs(data)
        for i in range(40):
            img = smooth_image(240 + 16 * (i % 4), 256 + 24 * (i % 3), seed=1000 + i)
            Image.fromarray(img).save(os.path.join(data, f"{i:03d}.jpg"), quality=92)
        style = os.path.join(tmp, "style.jpg")
        Image.fromarray(smooth_image(320, 320, seed=999)).save(style, quality=95)
        out = os.path.join(tmp, "out")
        for fn in counters.values():
            fn.launches = 0
        conv2d_same_dx.launches_by_route = dict.fromkeys(
            conv2d_same_dx.launches_by_route, 0)
        reset_launch_counts()
        t0 = time.perf_counter()
        final = begin_training.main([
            "--dataset_dir", data, "--style_image", style, "--output_dir", out,
            "--total_steps", str(TRAIN_STEPS), "--batch_size", str(TRAIN_BATCH),
            "--training_monitor_content_image", "", "--seed", str(seed)])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        by_route = dict(instance_norm_fwd.launches_by_route)
        bwd_by_route = dict(instance_norm_bwd.launches_by_route)
        conv_by_route = dict(conv2d_same_dx.launches_by_route)
        with open(os.path.join(out, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        checkpoints = sorted(os.listdir(os.path.join(out, "checkpoints")))
        sty = Stylizer.from_checkpoint(final)
        img = smooth_image(256, 256, seed=77)
        y = sty.stylize_u8(img)
        finite = all(np.isfinite(r[k]) for r in records
                     for k in ("loss", "content_loss", "style_loss", "tv_loss", "grad_norm"))
    expected = {"instance_norm_fwd": NUM_IN_SITES * TRAIN_STEPS,
                "instance_norm_bwd": NUM_IN_SITES * TRAIN_STEPS,
                "conv2d_same_dx": TRAIN_STEPS, "conv2d_same_bwd": 0,
                # conv1's pad of the image batch, which needs no gradient;
                # the pads of activations take autograd's route
                "reflect_pad": TRAIN_STEPS}
    ok = bool(finite and records and all(r["skipped_nonfinite"] == 0 for r in records)
          and records[-1]["step"] == TRAIN_STEPS
          and any(c.startswith("ckpt_") for c in checkpoints)
          and os.path.basename(final) == "style_transfer_final.npz"
          and y.shape == img.shape and y.dtype == np.uint8
          and launches == expected
          and by_route[SITE_ROUTE] == launches["instance_norm_fwd"]
          and bwd_by_route[SITE_ROUTE] == launches["instance_norm_bwd"]
          and conv_by_route == {"tap_packed": TRAIN_STEPS, "tiled": 0})
    emit("training", ok=ok, steps=TRAIN_STEPS, batch=TRAIN_BATCH, size=[256, 256],
         precision="f32", seconds=seconds, metrics=records, checkpoints=checkpoints,
         launches=launches, instance_norm_fwd_launches_by_route=by_route,
         instance_norm_bwd_launches_by_route=bwd_by_route,
         conv2d_same_dx_launches_by_route=conv_by_route,
         expected_launches=expected,
         stylized_shape=list(y.shape), stylized_mean=float(y.mean()))
    if not ok:
        fail("training phase")
    return {"launches": launches, "bwd_by_route": bwd_by_route,
            "conv_by_route": conv_by_route}


STYLES = 4  # the multi-style configuration: one net for four styles


def phase_multi_style(seed: int) -> dict:
    """The multi-style main path (conditional IN, ROADMAP row 10): the
    training CLI with STYLES seeded style images, TRAIN_STEPS steps at batch
    20, 256x256, f32 (the CLI's defaults), full width, launch counters set
    to 0 just before and read just after: 14 IN forwards and 14 IN
    backwards a step, all on the one-launch kernels and all with per-sample
    (B, C) affines ("sample"), and one tap-packed conv1_1 dx a step. Then
    the final .npz serves: Stylizer.from_checkpoint(style=1) and the blend
    style=[0.25] * 4, f32 and bf16 on the card, against the port's CPU f32
    path (f32 max |du8| <= 1, bf16 SSIM >= 0.98, 14 "channel" launches a
    forward: the style is baked); the inference CLI with --style_index 2
    against the CPU path likewise. Last, one f32 multi-style step on the
    card against the CPU step (phase_train_parity's tolerances, B=4, one
    example per style)."""
    import torch
    from PIL import Image

    from fast_neural_style_transfer_tpu_torch.cli import begin_inference, begin_training
    from fast_neural_style_transfer_tpu_torch.infer import Stylizer
    from fast_neural_style_transfer_tpu_torch.models import NUM_IN_SITES, num_styles
    from fast_neural_style_transfer_tpu_torch.models.weights import load_checkpoint
    from fast_neural_style_transfer_tpu_torch.ops.cuda_conv import conv2d_same_dx
    from fast_neural_style_transfer_tpu_torch.ops.cuda_norm import (
        instance_norm_bwd,
        instance_norm_fwd,
    )
    from fast_neural_style_transfer_tpu_torch.utils.ssim import ssim

    result = {}
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        os.makedirs(data)
        for i in range(40):
            img = smooth_image(240 + 16 * (i % 4), 256 + 24 * (i % 3), seed=1000 + i)
            Image.fromarray(img).save(os.path.join(data, f"{i:03d}.jpg"), quality=92)
        styles = []
        for s in range(STYLES):
            styles.append(os.path.join(tmp, f"style{s}.jpg"))
            Image.fromarray(smooth_image(320, 320, seed=990 + s)).save(styles[-1], quality=95)
        out = os.path.join(tmp, "out")
        reset_launch_counts()
        conv2d_same_dx.launches = 0
        conv2d_same_dx.launches_by_route = dict.fromkeys(conv2d_same_dx.launches_by_route, 0)
        t0 = time.perf_counter()
        final = begin_training.main([
            "--dataset_dir", data, "--style_image", *styles, "--output_dir", out,
            "--total_steps", str(TRAIN_STEPS), "--batch_size", str(TRAIN_BATCH),
            "--training_monitor_content_image", "", "--seed", str(seed)])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {name: {"launches": fn.launches, "by_route": dict(fn.launches_by_route),
                         "by_affine": dict(fn.launches_by_affine)}
                  for name, fn in (("instance_norm_fwd", instance_norm_fwd),
                                   ("instance_norm_bwd", instance_norm_bwd))}
        counts["conv2d_same_dx"] = {"launches": conv2d_same_dx.launches,
                                    "by_route": dict(conv2d_same_dx.launches_by_route)}
        with open(os.path.join(out, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        steps = NUM_IN_SITES * TRAIN_STEPS
        ok = (all(counts[k]["launches"] == steps
                  and nonzero(counts[k]["by_route"]) == {SITE_ROUTE: steps}
                  and counts[k]["by_affine"] == {"channel": 0, "sample": steps}
                  for k in ("instance_norm_fwd", "instance_norm_bwd"))
              and counts["conv2d_same_dx"] == {"launches": TRAIN_STEPS, "by_route": {
                  "tap_packed": TRAIN_STEPS, "tiled": 0}}
              and records and records[-1]["step"] == TRAIN_STEPS
              and all(r["skipped_nonfinite"] == 0 and np.isfinite(r["loss"])
                      for r in records)
              and num_styles(load_checkpoint(final)) == STYLES)
        emit("multi_style_training", ok=ok, styles=STYLES, steps=TRAIN_STEPS,
             batch=TRAIN_BATCH, size=[256, 256], precision="f32", seconds=seconds,
             counts=counts, metrics=records)
        if not ok:
            fail("multi-style training phase")
        result["counts"] = counts

        img = smooth_image(256, 256, seed=78)
        for style in (1, [0.25] * STYLES):
            want = Stylizer.from_checkpoint(final, style=style, device="cpu").stylize_u8(img)
            for precision in ("f32", "bf16"):
                card = Stylizer.from_checkpoint(final, style=style, precision=precision)
                reset_launch_counts()
                got = card.stylize_u8(img)
                by_affine = dict(instance_norm_fwd.launches_by_affine)
                du8 = int(np.abs(got.astype(int) - want.astype(int)).max())
                score = ssim(got / 255.0, want / 255.0)
                ok = (by_affine == {"channel": NUM_IN_SITES, "sample": 0}
                      and (du8 <= 1 if precision == "f32" else score >= 0.98))
                emit("multi_style_serving", style=style, precision=precision,
                     max_abs_du8=du8, ssim=score, launches_by_affine=by_affine,
                     criterion="max|du8|<=1" if precision == "f32" else "ssim>=0.98",
                     ok=ok)
                if not ok:
                    fail(f"multi-style serving (style={style}, {precision})")
        src = os.path.join(tmp, "content.jpg")
        Image.fromarray(smooth_image(240, 320, seed=79)).save(src, quality=95)
        begin_inference.main(["--model_path", final, "--content_image", src,
                              "--output_dir", tmp, "--output_name", "cli.png",
                              "--style_index", "2"])
        got = np.asarray(Image.open(os.path.join(tmp, "cli.png")), np.int32)
        cpu = Stylizer.from_checkpoint(final, style=2, device="cpu")
        want = cpu.stylize_u8(np.asarray(Image.open(src).convert("RGB"))).astype(np.int32)
        du8 = int(np.abs(got - want).max())
        ok = got.shape == (240, 320, 3) and du8 <= 1
        emit("multi_style_inference_cli", style_index=2, precision="f32",
             max_abs_du8=du8, criterion="max|du8|<=1", ok=ok)
        if not ok:
            fail("multi-style inference CLI")
    phase_train_parity(seed, variant="multi_style", styles=STYLES, batch=STYLES)
    return result


def _one_train_step(device: str, seed: int, size: int = 128, batch: int = 2,
                    styles: int = 1, norm_method: str = "auto"):
    """One f32 step without dropout from seeded params, VGG and batch ->
    (loss, grads, grad_norm, params before, params after, state.step),
    all on the CPU. ``styles`` > 1: a multi-style net whose IN banks' rows
    differ (gamma 1 + 0.1 N(0, 1), beta 0.1 N(0, 1), seeded), on (S, c, c)
    Gram banks of S seeded style images, example i on style i % S (an
    explicit one-hot style_select, the same on both devices)."""
    import torch

    from fast_neural_style_transfer_tpu_torch.core.dtypes import Precision
    from fast_neural_style_transfer_tpu_torch.losses import LossTaps
    from fast_neural_style_transfer_tpu_torch.train.schedule import LossWeightSchedule
    from fast_neural_style_transfer_tpu_torch.train.state import create_train_state
    from fast_neural_style_transfer_tpu_torch.train.step import loss_fn, make_train_step

    net, vgg, u8, grams, select = _train_inputs(device, seed, size, batch, styles)
    prec, taps = Precision.f32(), LossTaps()
    cpu = lambda ts: [t.detach().float().cpu().clone() for t in ts]
    params = list(net.parameters())
    before = cpu(params)
    total, _ = loss_fn(net, vgg, u8, grams, LossWeightSchedule()(0), taps=taps,
                       precision=prec, dropout=False, style_select=select,
                       norm_method=norm_method)
    grads = torch.autograd.grad(total, params)
    state = create_train_state(net)
    metrics = make_train_step(dropout=False, num_styles=styles, norm_method=norm_method)(
        state, vgg, u8, grams, style_select=select)
    return (float(metrics["loss"]), cpu(grads), float(metrics["grad_norm"]), before,
            cpu(net.parameters()), state.step)


def _train_inputs(device: str, seed: int, size: int, batch: int, styles: int = 1):
    """The seeded stylizer (f32, TF32 off), random VGG, uint8 batch and
    style Grams of ``_one_train_step`` -> (net, vgg, u8, grams,
    style_select)."""
    import torch

    from fast_neural_style_transfer_tpu_torch.core.dtypes import Precision
    from fast_neural_style_transfer_tpu_torch.losses import (
        LossTaps,
        style_targets_from_features,
    )
    from fast_neural_style_transfer_tpu_torch.models import TransformerNet
    from fast_neural_style_transfer_tpu_torch.models.vgg_weights import make_vgg, random_params
    from fast_neural_style_transfer_tpu_torch.train.step import exact_f32
    from fast_neural_style_transfer_tpu_torch.utils.image_io import u8_to_network

    prec = Precision.f32()
    exact_f32(torch.device(device), prec)
    torch.manual_seed(seed)
    net = TransformerNet(num_styles=styles)
    if styles > 1:  # rows that differ, so each example's style matters
        with torch.no_grad():
            for name, p in net.named_parameters():
                if p.dim() == 2:
                    p.copy_(torch.randn(p.shape) * 0.1
                            + (1.0 if name.endswith("weight") else 0.0))
    net = net.to(device, memory_format=torch.channels_last)
    vgg = make_vgg(random_params(seed), device)
    taps = LossTaps()
    u8 = torch.from_numpy(np.stack([smooth_image(size, size, seed=10 + i)
                                    for i in range(batch)])).to(device)
    per_style = []
    for s in range(styles):
        style = u8_to_network(torch.from_numpy(
            smooth_image(size, size, seed=5 + 100 * s))[None]).to(device)
        with torch.no_grad():
            per_style.append(style_targets_from_features(
                vgg(style, taps.style_taps, precision=prec)))
    select = None
    if styles == 1:
        grams = per_style[0]
    else:
        grams = [torch.stack(layer) for layer in zip(*per_style)]
        select = torch.eye(styles, device=device)[torch.arange(batch) % styles]
    return net, vgg, u8, grams, select


@contextlib.contextmanager
def deterministic_algorithms():
    """PyTorch's deterministic algorithms and cuDNN's deterministic
    convolutions, restored on exit."""
    import torch

    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled(),
           torch.backends.cudnn.deterministic)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
        torch.backends.cudnn.deterministic = was[2]


def _param_names(styles: int):
    from fast_neural_style_transfer_tpu_torch.models import TransformerNet

    return list(TransformerNet(num_styles=styles).named_parameters())


def phase_train_parity(seed: int, variant: str = "single_style", styles: int = 1,
                       batch: int = 2, norm_method: str = "auto") -> None:
    """One f32 step (128x128, B=2, no dropout; ``variant``: other style
    counts, batches or IN statistics) on the card against the port's CPU
    path from the same seeded params, VGG and batch. Tolerances:
    loss and gradient global norm relative 1e-4, every gradient element
    within 1e-3 of the largest gradient (f32 sums in other orders through
    ~30 layers). Updated params: Adam's first update is lr * u(g), u(g) =
    g / (|g| + 1e-8), with g the clipped gradient plus 1e-5 * param; the
    clip divides by the global norm (~2e5 here), which puts part of the
    elements within a few hundred 1e-8 of zero, where u swings with the
    last bits of g (du/dg = 1e-8 / (|g| + 1e-8)^2). So every element within
    2 lr (the most two updates can differ), and every element whose
    effective gradient is at least 1e-4 on the CPU (where du/dg <= 1)
    within 1e-3 lr.

    The card's step runs with PyTorch's deterministic algorithms (cuDNN's
    among them), so that it repeats bit for bit. Under cuDNN's default
    choice the convolution algorithm follows the card's free memory, and
    the grad norm moved by up to 7e-5 relative from run to run with
    one-pass statistics (1e-5 stable): the step is ill-conditioned in its
    IN statistics (on the CPU, f64 statistics move the grad norm 1.2e-4
    from the f32 ones), so an f32 summation order decides its fifth
    digit."""
    lr = 1e-3
    with deterministic_algorithms():
        card = _one_train_step("cuda", seed, batch=batch, styles=styles,
                               norm_method=norm_method)
    cpu = _one_train_step("cpu", seed, batch=batch, styles=styles,
                          norm_method=norm_method)
    loss_rel = abs(card[0] - cpu[0]) / abs(cpu[0])
    gmax = max(g.abs().max().item() for g in cpu[1])
    errs = [(a - b).abs().max().item() for a, b in zip(card[1], cpu[1])]
    grad_err = max(errs) / gmax
    names = [n for n, _ in _param_names(styles)]
    worst = int(np.argmax(errs))
    norm_rel = abs(card[2] - cpu[2]) / cpu[2]
    dp = [(a - b).abs() / lr for a, b in zip(card[4], cpu[4])]
    numel = sum(d.numel() for d in dp)
    off = [d > 1e-3 for d in dp]
    frac_off = sum(o.sum().item() for o in off) / numel
    # the CPU side's effective gradient where an element is off by > 1e-3 lr
    scale = min(1.0, 1.0 / cpu[2])
    g_eff = [(g * scale + 1e-5 * p).abs() for g, p in zip(cpu[1], cpu[3])]
    g_eff_off = max((ge[o].max().item() for ge, o in zip(g_eff, off) if o.any()),
                    default=0.0)
    dp_max = max(d.max().item() for d in dp)
    ok = (loss_rel <= 1e-4 and norm_rel <= 1e-4 and grad_err <= 1e-3
          and dp_max <= 2 and g_eff_off < 1e-4 and card[5] == cpu[5] == 1)
    emit("train_parity", ok=ok, variant=variant, size=[128, 128], batch=batch,
         styles=styles, norm_method=norm_method, precision="f32",
         loss_card=card[0], loss_cpu=cpu[0], loss_rel_err=loss_rel,
         grad_norm_card=card[2], grad_norm_cpu=cpu[2], grad_norm_rel_err=norm_rel,
         grad_max_abs_err_over_max_grad=grad_err, worst_grad_param=names[worst],
         worst_grad_param_max=cpu[1][worst].abs().max().item(), max_grad=gmax,
         param_max_abs_err_over_lr=dp_max,
         param_mean_abs_err_over_lr=sum(d.sum().item() for d in dp) / numel,
         param_frac_off_over_1e_3_lr=frac_off,
         largest_effective_grad_where_off=g_eff_off, steps=[card[5], cpu[5]],
         card_deterministic_algorithms=True)
    if not ok:
        fail(f"card-vs-CPU train step parity ({variant})")


IN_BWD_FLOPS_PER_ELEMENT = 16  # the TPU kernel's cost estimate
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # H100 SXM dense


def bound(bytes_moved: float, flops: float, dtype: str) -> tuple:
    """(least ms, "bytes" or "operations"): the larger of bytes over HBM
    and operations over the peak rate of their type."""
    b_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    o_ms = flops / PEAK_FLOPS[dtype] * 1e3
    return max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations"


def train_kernel_times(seed: int) -> dict:
    """Per training step at B=20, 256x256, in bf16 and f32: device time
    (CUDA-graph replay) of the IN forward and backward (each the kernel its
    planner picks, and the two-launch kernel at the same shapes:
    ``two_launch_ms``) over the 14 sites and of the conv1_1 dx kernel (the
    tap-packed kernel its planner picks, and the tiled kernel at the same
    shapes: ``tiled_ms``), their plain versions and the library
    calls (F.instance_norm(+F.relu); its autograd backward, as the graph
    time of forward + backward less that of the forward; cuDNN
    backward-data torch.nn.grad.conv2d_input), beside the bounds. The IN
    kernels also with per-sample (B, C) affines, as multi-style training
    calls them (``sample_affine_ms``; ``ms`` is the (C,) call)."""
    import torch
    import torch.nn.functional as F

    from fast_neural_style_transfer_tpu_torch.ops.cuda_conv import (
        _launch_dx,
        conv2d_same_dx,
        conv2d_same_dx_reference,
        conv_dx_plan,
    )
    from fast_neural_style_transfer_tpu_torch.ops.cuda_norm import (
        _launch_bwd,
        _launch_fwd,
        bwd_plan,
        fwd_plan,
        instance_norm_bwd,
        instance_norm_bwd_reference,
        instance_norm_fwd,
        instance_norm_fwd_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    n = TRAIN_BATCH
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).replace("torch.", "")
        keys = ("ms", "sample_affine_ms", "two_launch_ms", "plain_ms", "library_ms",
                "bound_ms")
        tot, fwd = dict.fromkeys(keys, 0.0), dict.fromkeys(keys, 0.0)
        for name, h, w, c, relu, count in SITES:
            x = (torch.randn((n, c, h, w), generator=gen, device="cuda") * 2 + 0.5)
            x = x.to(dtype).contiguous(memory_format=torch.channels_last)
            g = torch.randn((n, c, h, w), generator=gen, device="cuda").to(dtype)
            g = g.contiguous(memory_format=torch.channels_last)
            gamma = torch.randn(c, generator=gen, device="cuda")
            beta = torch.randn(c, generator=gen, device="cuda")
            g_rows = torch.randn((n, c), generator=gen, device="cuda")
            b_rows = torch.randn((n, c), generator=gen, device="cuda")
            with torch.no_grad():
                _, mean, inv = instance_norm_fwd(x, gamma, beta)

                def library_fwd():
                    y = F.instance_norm(x, weight=gamma, bias=beta, eps=1e-5)
                    return F.relu(y) if relu else y

                two = fwd_plan(x, one_launch=False)
                site_fwd = {
                    "ms": graph_ms(lambda: instance_norm_fwd(x, gamma, beta, relu=relu)),
                    "sample_affine_ms": graph_ms(lambda: instance_norm_fwd(
                        x, g_rows, b_rows, relu=relu)),
                    "two_launch_ms": graph_ms(lambda: _launch_fwd(
                        x, gamma, beta, two, eps=1e-5, relu=relu, onepass=False)),
                    "plain_ms": graph_ms(lambda: instance_norm_fwd_reference(
                        x, gamma, beta, relu=relu)),
                    "library_ms": graph_ms(library_fwd),
                    "bound_ms": bound(2 * x.numel() * x.element_size(),
                                      IN_FLOPS_PER_ELEMENT * x.numel(), dname)[0],
                }
            for k in fwd:
                fwd[k] += count * site_fwd[k]
            xr = x.detach().requires_grad_()
            gr = gamma.detach().requires_grad_()
            br = beta.detach().requires_grad_()

            def library_fwd():
                y = F.instance_norm(xr, weight=gr, bias=br, eps=1e-5)
                return F.relu(y) if relu else y

            lib_fwd_bwd = graph_ms(lambda: torch.autograd.grad(
                library_fwd(), (xr, gr, br), g))
            plan, two_bwd = bwd_plan(x, g), bwd_plan(x, g, one_launch=False)
            site = {
                "ms": graph_ms(lambda: instance_norm_bwd(x, g, mean, inv, gamma, beta,
                                                         relu=relu)),
                "sample_affine_ms": graph_ms(lambda: instance_norm_bwd(
                    x, g, mean, inv, g_rows, b_rows, relu=relu)),
                "two_launch_ms": graph_ms(lambda: _launch_bwd(
                    x, g, mean, inv, gamma, beta, two_bwd, relu=relu)),
                "plain_ms": graph_ms(lambda: instance_norm_bwd_reference(
                    x, g, mean, inv, gamma, beta, relu=relu)),
                "library_ms": lib_fwd_bwd - graph_ms(library_fwd),
            }
            site["bound_ms"], by = bound(3 * x.numel() * x.element_size(),
                                         IN_BWD_FLOPS_PER_ELEMENT * x.numel(), dname)
            emit("train_times_in_bwd_site", site=name, shape=[n, h, w, c], dtype=dname,
                 relu=relu, sites_per_step=count, route=plan.route,
                 chunks_per_sample=plan.chunks, bound_by=by,
                 library_fwd_bwd_ms=lib_fwd_bwd,
                 library_op="autograd of F.instance_norm" + ("+F.relu" if relu else ""),
                 **site)
            for k in tot:
                tot[k] += count * site[k]
            del xr, gr, br
        tot["bound_by"] = fwd["bound_by"] = "bytes"
        emit("train_times_in_fwd", dtype=dname, batch=n, per="step (14 sites)",
             route=fwd_plan(x).route, **fwd,
             library_op="F.instance_norm(+F.relu)", bound_share=fwd["bound_ms"] / fwd["ms"])
        emit("train_times_in_bwd", dtype=dname, batch=n, per="step (14 sites)",
             route=plan.route, **tot, bound_share=tot["bound_ms"] / tot["ms"])
        out[("in_fwd", dname)] = fwd
        out[("in_bwd", dname)] = tot

        g = torch.randn((n, 64, 256, 256), generator=gen, device="cuda").to(dtype)
        g = g.contiguous(memory_format=torch.channels_last)
        wt = (torch.randn((64, 3, 3, 3), generator=gen, device="cuda") * 0.1).to(dtype)
        tiled = conv_dx_plan(g, wt, tap_packed=False)
        conv = {
            "ms": graph_ms(lambda: conv2d_same_dx(g, wt)),
            "tiled_ms": graph_ms(lambda: _launch_dx(g, wt, tiled)),
            "plain_ms": graph_ms(lambda: conv2d_same_dx_reference(g, wt)),
            "library_ms": graph_ms(lambda: torch.nn.grad.conv2d_input(
                (n, 3, 256, 256), wt, g, padding=1)),
        }
        dx_bytes = n * 3 * 256 * 256 * g.element_size()
        conv["bound_ms"], conv["bound_by"] = bound(
            g.numel() * g.element_size() + dx_bytes, 2 * 27 * 64 * n * 256 * 256, dname)
        emit("train_times_conv_dx", dtype=dname, shape=[n, 256, 256], c_in=3, c_out=64,
             k=3, per="step (1 launch)", library_op="torch.nn.grad.conv2d_input (cuDNN)",
             route=conv_dx_plan(g, wt).route, blocks=conv_dx_plan(g, wt).blocks,
             **conv, bound_share=conv["bound_ms"] / conv["ms"])
        out[("conv_dx", dname)] = conv
    return out


def count_gradient_copies(fn) -> dict:
    """Run ``fn`` (one training step) with the backward of each kernel's
    autograd Function watched: per Function, how many upstream gradients
    arrived outside channels_last (the wrapper copies them) or in another
    dtype than the saved input (cast)."""
    import torch

    from fast_neural_style_transfer_tpu_torch.ops.cuda_conv import Conv2dSameSmallCinFn
    from fast_neural_style_transfer_tpu_torch.ops.cuda_norm import InstanceNormFn

    counts, originals = {}, {}
    for cls in (InstanceNormFn, Conv2dSameSmallCinFn):
        originals[cls] = orig = cls.backward
        c = counts[cls.__name__] = {"calls": 0, "not_channels_last": 0, "cast": 0}

        def watched(ctx, gy, _orig=orig, _c=c):
            _c["calls"] += 1
            _c["not_channels_last"] += int(
                not gy.is_contiguous(memory_format=torch.channels_last))
            _c["cast"] += int(gy.dtype != ctx.saved_tensors[0].dtype)
            return _orig(ctx, gy)

        cls.backward = staticmethod(watched)
    try:
        fn()
    finally:
        for cls, orig in originals.items():
            cls.backward = staticmethod(orig)
    return counts


TRAIN_VARIANTS = (("single_style", 1, "auto"), ("multi_style", STYLES, "auto"),
                  ("onepass", 1, "onepass"))


def phase_train_times(seed: int) -> dict:
    """Training step p50 at B=20, 256x256, bf16 and f32 (CUDA events
    around each step, which ends in the non-finite guard's sync, after 3
    warm-up steps; the host clock beside them) for each of TRAIN_VARIANTS:
    single-style, the STYLES-style net (a style drawn per example) and
    one-pass IN statistics, with the IN launches of the timed steps by
    route and by affine; for single-style also the layout copies and casts
    ahead of the kernels' backward (count_gradient_copies) and a
    torch.profiler breakdown of one bf16 step by kernel and by aten op;
    then the kernels' per-step times (train_kernel_times)."""
    import torch

    from fast_neural_style_transfer_tpu_torch.core.dtypes import canonical_compute_dtype
    from fast_neural_style_transfer_tpu_torch.losses import (
        LossTaps,
        style_targets_from_features,
    )
    from fast_neural_style_transfer_tpu_torch.models import TransformerNet
    from fast_neural_style_transfer_tpu_torch.models.vgg_weights import make_vgg, random_params
    from fast_neural_style_transfer_tpu_torch.ops.cuda_norm import instance_norm_fwd
    from fast_neural_style_transfer_tpu_torch.train.state import create_train_state
    from fast_neural_style_transfer_tpu_torch.train.step import exact_f32, make_train_step
    from fast_neural_style_transfer_tpu_torch.utils.image_io import u8_to_network

    u8 = torch.from_numpy(np.stack([smooth_image(256, 256, seed=2000 + i)
                                    for i in range(TRAIN_BATCH)])).cuda()
    style_imgs = [u8_to_network(torch.from_numpy(
        smooth_image(256, 256, seed=5 + 100 * s))[None]).cuda() for s in range(STYLES)]
    result = {}
    for precision, (variant, styles, norm_method) in (
            (p, v) for p in ("bf16", "f32") for v in TRAIN_VARIANTS):
        prec = canonical_compute_dtype(precision)
        exact_f32(torch.device("cuda"), prec)
        torch.manual_seed(seed)
        net = TransformerNet(num_styles=styles).cuda().to(memory_format=torch.channels_last)
        vgg = make_vgg(random_params(seed), "cuda")
        taps = LossTaps()
        with torch.no_grad():
            per_style = [style_targets_from_features(vgg(s, taps.style_taps, precision=prec))
                         for s in style_imgs[:styles]]
        grams = (per_style[0] if styles == 1
                 else [torch.stack(layer) for layer in zip(*per_style)])
        state = create_train_state(net)
        step = make_train_step(precision=prec, num_styles=styles,
                               norm_method=norm_method)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        for _ in range(3):
            step(state, vgg, u8, grams, gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        samples, host = [], []
        for _ in range(10):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            m = step(state, vgg, u8, grams, gen)
            end.record()
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
            samples.append(start.elapsed_time(end))
        p50 = float(np.median(samples))
        by_route = dict(instance_norm_fwd.launches_by_route)
        by_affine = dict(instance_norm_fwd.launches_by_affine)
        emit("train_step_time", variant=variant, styles=styles, norm_method=norm_method,
             precision=precision, batch=TRAIN_BATCH, size=[256, 256],
             p50_ms=p50, min_ms=float(np.min(samples)), max_ms=float(np.max(samples)),
             host_p50_ms=float(np.median(host)), images_per_s=TRAIN_BATCH / p50 * 1e3,
             peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
             loss=float(m["loss"]), in_fwd_launches_by_route=by_route,
             in_fwd_launches_by_affine=by_affine)
        if by_route["two_launch"] or by_affine["sample" if styles == 1 else "channel"]:
            fail(f"train_times {variant} {precision}: IN forward off the one-launch "
                 f"kernel or on the wrong affine ({by_route}, {by_affine})")
        result[(variant, precision)] = p50
        if variant != "single_style":
            del net, vgg, state, step
            torch.cuda.empty_cache()
            continue
        emit("train_gradient_copies", precision=precision,
             **count_gradient_copies(lambda: step(state, vgg, u8, grams, gen)))
        if precision == "bf16":
            emit("train_profile", precision=precision, batch=TRAIN_BATCH,
                 **profile_calls(lambda: step(state, vgg, u8, grams, gen), reps=2, top=16))
        del net, vgg, state, step
        torch.cuda.empty_cache()
    result["kernels"] = train_kernel_times(seed)
    return result


IN_FWD_BUDGETS_KB = (64, 80, 96)


def phase_in_fwd_budgets(seed: int) -> dict:
    """The one-launch IN forward at chunk budgets of 64, 80 and 96 KB
    (ops/cuda_norm.py::_FWD_CHUNK_BYTES; the port's is 80): device time
    (CUDA-graph replay) per 256x256 forward at B=1 and B=8 in bf16 and per
    training step at B=20 in bf16 and f32, each site shape weighted by its
    sites (ReLU on)."""
    import torch

    from fast_neural_style_transfer_tpu_torch.ops import cuda_norm

    gen = torch.Generator(device="cuda").manual_seed(seed + 4)
    weights = {}
    for _, h, w, c, _, count in SITES:
        weights[(h, w, c)] = weights.get((h, w, c), 0) + count
    keep = cuda_norm._FWD_CHUNK_BYTES
    result = {}
    try:
        for n, dtype in ((1, torch.bfloat16), (8, torch.bfloat16),
                         (TRAIN_BATCH, torch.bfloat16), (TRAIN_BATCH, torch.float32)):
            per_budget = dict.fromkeys(IN_FWD_BUDGETS_KB, 0.0)
            chunks = {kb: [] for kb in IN_FWD_BUDGETS_KB}
            for (h, w, c), count in weights.items():
                x = (torch.randn((n, c, h, w), generator=gen, device="cuda") * 2 + 0.5)
                x = x.to(dtype).contiguous(memory_format=torch.channels_last)
                g = torch.randn(c, generator=gen, device="cuda")
                b = torch.randn(c, generator=gen, device="cuda")
                for kb in IN_FWD_BUDGETS_KB:
                    cuda_norm._FWD_CHUNK_BYTES = kb * 1024
                    plan = cuda_norm.fwd_plan(x)
                    per_budget[kb] += count * graph_ms(lambda: cuda_norm._launch_fwd(
                        x, g, b, plan, eps=1e-5, relu=True, onepass=False))
                    chunks[kb].append(plan.chunks)
            dname = str(dtype).replace("torch.", "")
            emit("in_fwd_budgets", batch=n, dtype=dname,
                 per="forward" if n < TRAIN_BATCH else "step", port_kb=keep // 1024,
                 ms_by_budget_kb=per_budget, chunks_per_sample_by_budget_kb=chunks)
            result[(n, dname)] = per_budget
    finally:
        cuda_norm._FWD_CHUNK_BYTES = keep
    return result


IN_BWD_BUDGETS_KB = (64, 80, 96)


def phase_in_bwd_budgets(seed: int) -> dict:
    """The one-launch IN backward at chunk budgets (x and g together) of 64,
    80 and 96 KB (ops/cuda_norm.py::_BWD_CHUNK_BYTES; the port's is 80;
    the block's shared memory caps the chunk where 96 KB does not fit):
    device time (CUDA-graph replay) per training step at B=20 in bf16 and
    f32, each site shape weighted by its sites (ReLU on)."""
    import torch

    from fast_neural_style_transfer_tpu_torch.ops import cuda_norm

    gen = torch.Generator(device="cuda").manual_seed(seed + 5)
    weights = {}
    for _, h, w, c, _, count in SITES:
        weights[(h, w, c)] = weights.get((h, w, c), 0) + count
    keep = cuda_norm._BWD_CHUNK_BYTES
    result = {}
    try:
        for dtype in (torch.bfloat16, torch.float32):
            per_budget = dict.fromkeys(IN_BWD_BUDGETS_KB, 0.0)
            chunks = {kb: [] for kb in IN_BWD_BUDGETS_KB}
            for (h, w, c), count in weights.items():
                shape = (TRAIN_BATCH, c, h, w)
                x = torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5
                x = x.to(dtype).contiguous(memory_format=torch.channels_last)
                g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
                g = g.contiguous(memory_format=torch.channels_last)
                gamma = torch.randn(c, generator=gen, device="cuda")
                beta = torch.randn(c, generator=gen, device="cuda")
                with torch.no_grad():
                    _, mean, inv = cuda_norm.instance_norm_fwd(x, gamma, beta)
                for kb in IN_BWD_BUDGETS_KB:
                    cuda_norm._BWD_CHUNK_BYTES = kb * 1024
                    plan = cuda_norm.bwd_plan(x, g)
                    per_budget[kb] += count * graph_ms(lambda: cuda_norm._launch_bwd(
                        x, g, mean, inv, gamma, beta, plan, relu=True))
                    chunks[kb].append(plan.chunks)
            dname = str(dtype).replace("torch.", "")
            emit("in_bwd_budgets", batch=TRAIN_BATCH, dtype=dname, per="step",
                 port_kb=keep // 1024, ms_by_budget_kb=per_budget,
                 chunks_per_sample_by_budget_kb=chunks)
            result[dname] = per_budget
    finally:
        cuda_norm._BWD_CHUNK_BYTES = keep
    return result


def graph_ms(fn, reps: int = 20) -> float:
    """Device time per call: ``reps`` calls captured in one CUDA graph and
    replayed, so host-side launch cost is out of the measurement."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, iters=10) / reps


def phase_times(seed: int) -> dict:
    """bf16 per-site times at B=1 and B=8 for the kernel (and the two-launch
    kernel at the same shapes, ``two_launch_ms``), its plain version and
    F.instance_norm (+ F.relu at ReLU sites): device time from CUDA
    graph replay (``*ms``) and the eager call loop between CUDA events
    (``eager_*ms``, which includes the host's launch cost), each beside the
    bytes bound. Then the u8 -> u8 forward p50 at 256^2 and, from
    torch.profiler, the device's busy share over those forwards."""
    import torch
    import torch.nn.functional as F

    from fast_neural_style_transfer_tpu_torch.infer import Stylizer
    from fast_neural_style_transfer_tpu_torch.ops.cuda_norm import (
        _launch_fwd,
        fwd_plan,
        instance_norm_fwd,
        instance_norm_fwd_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(seed)
    per_forward = {}
    keys = ("ms", "two_launch_ms", "plain_ms", "library_ms", "eager_ms",
            "eager_plain_ms", "eager_library_ms", "bound_ms")
    with torch.inference_mode():
        for n in (1, 8):
            tot = dict.fromkeys(keys, 0.0)
            bound_by = set()
            for name, h, w, c, relu, count in SITES:
                x = (torch.randn((n, c, h, w), generator=gen, device="cuda") * 2 + 0.5)
                x = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
                g = torch.randn(c, generator=gen, device="cuda")
                b = torch.randn(c, generator=gen, device="cuda")

                def kernel():
                    return instance_norm_fwd(x, g, b, relu=relu)

                def plain():
                    return instance_norm_fwd_reference(x, g, b, relu=relu)

                def library():
                    y = F.instance_norm(x, weight=g, bias=b, eps=1e-5)
                    return F.relu(y) if relu else y

                two = fwd_plan(x, one_launch=False)
                site = {
                    "ms": graph_ms(kernel),
                    "two_launch_ms": graph_ms(lambda: _launch_fwd(
                        x, g, b, two, eps=1e-5, relu=relu, onepass=False)),
                    "plain_ms": graph_ms(plain),
                    "library_ms": graph_ms(library),
                    "eager_ms": cuda_ms(kernel, iters=100),
                    "eager_plain_ms": cuda_ms(plain, iters=20),
                    "eager_library_ms": cuda_ms(library, iters=50),
                }
                site["bound_ms"], by = in_bound_ms(x.numel(), x.element_size())
                bound_by.add(by)
                emit("times_site", site=name, shape=[n, h, w, c], dtype="bfloat16",
                     relu=relu, route=fwd_plan(x).route, **site, bound_by=by,
                     library_op="F.instance_norm+F.relu" if relu else "F.instance_norm",
                     bound_share=site["bound_ms"] / site["ms"],
                     sites_per_forward=count)
                for key in keys:
                    tot[key] += count * site[key]
            tot["bound_by"] = "+".join(sorted(bound_by))
            per_forward[n] = tot
            emit("times_per_forward", batch=n, dtype="bfloat16", **tot,
                 bound_share=tot["bound_ms"] / tot["ms"])

    sty = Stylizer.from_checkpoint(str(CHECKPOINT), precision="bf16")
    latency = {}
    for n in (1, 8):
        x = torch.from_numpy(np.stack([smooth_image(256, 256, seed=20 + i)
                                       for i in range(n)])).cuda()
        for _ in range(3):
            sty.raw_forward_u8(x)
        torch.cuda.synchronize()
        samples = []
        for _ in range(20):
            t0 = time.perf_counter()
            sty.raw_forward_u8(x)
            torch.cuda.synchronize()
            samples.append((time.perf_counter() - t0) * 1e3)
        latency[n] = float(np.median(samples))
        emit("stylize_latency", batch=n, size=[256, 256], precision="bf16",
             p50_ms=latency[n], min_ms=float(np.min(samples)),
             images_per_s=n / latency[n] * 1e3)
        emit("stylize_profile", batch=n,
             **profile_calls(lambda: sty.raw_forward_u8(x), reps=5))
    return {"per_forward": per_forward, "latency": latency}


def profile_calls(fn, reps: int = 5, top: int = 8) -> dict:
    """Device busy share over ``reps`` calls of ``fn``, and device time by
    kernel name (the ``top`` largest, per call, with launches per call),
    from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    self_us = lambda e: getattr(e, "self_device_time_total",
                                getattr(e, "self_cuda_time_total", 0.0))
    busy_ms = sum(self_us(e) for e in device) / 1e3
    ranked = sorted(device, key=self_us, reverse=True)[:top]
    # the aten ops that launched the device time (self: their own kernels)
    ops = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CPU and e.key.startswith("aten::")
           and self_us(e) > 0]
    ops = sorted(ops, key=self_us, reverse=True)[:top]
    return {
        "wall_ms_per_call": wall_ms / reps,
        "device_ms_per_call": busy_ms / reps,
        "device_busy_share": busy_ms / wall_ms if busy_ms else "not measured",
        "top_kernels_ms_per_call": [
            [e.key[:80], self_us(e) / 1e3 / reps, e.count / reps] for e in ranked],
        "top_aten_ops_device_ms_per_call": [
            [e.key, self_us(e) / 1e3 / reps, e.count / reps] for e in ops],
    }


# -- slice 8: frozen IN statistics (video) and the AdaIN family ----------------

IN_STATS_BATCHES = (1, 8)
IN_STATS_BLENDS = (0.0, 0.5, 1.0)


def phase_in_stats_vs_plain(seed: int) -> dict:
    """The IN forward's capture and inject modes against their plain
    versions at the site shapes, B = 1 and 8, and the large slab at B = 2
    (two launches), f32 and bf16, with (C,) and (N, C) affines: capture
    returns the plain call's y, mean and inv bit for bit and a var within
    1e-4 relative of the plain version's; capture -> inject at blend 1 with
    the captured (N, C) moments gives the plain kernel forward's y bit for
    bit, at every site; capture's y agrees with the plain version within the
    forward's tolerances; inject against (1, C) and (N, C) references at
    blend 0, 0.5, 1 agrees with the plain inject within the forward's
    tolerances (phase_kernel_vs_plain: f32 |dy| <= 1e-4 + 1e-4|y|, bf16
    1e-4 + 2^-7|y|; own moments as there) and repeats bit for bit. The
    256^2 sites take the one-launch route and blend 1 the inject kernel.
    Returns the largest |dy| of capture and of inject."""
    import torch

    from fast_neural_style_transfer_tpu_torch.ops.cuda_norm import (
        fwd_plan,
        instance_norm_apply_stats,
        instance_norm_apply_stats_reference,
        instance_norm_fwd,
        instance_norm_fwd_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(seed + 11)
    worst = {"capture": 0.0, "inject": 0.0}
    shapes = sorted({(h, w, c, relu) for _, h, w, c, relu, _ in SITES})
    cases = [(n, *sh, False) for sh in shapes for n in IN_STATS_BATCHES]
    cases.append((*LARGE_SLAB, True))
    with torch.inference_mode():
        for n, h, w, c, relu, large in cases:
            base = torch.randn((n, c, h, w), generator=gen, device="cuda") * 2 + 0.5
            rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
            affines = {"channel": (rnd(c), rnd(c)), "sample": (rnd(n, c), rnd(n, c))}
            refs = {"one": (rnd(1, c), rnd(1, c).abs() + 0.5),
                    "per_sample": (rnd(n, c), rnd(n, c).abs() + 0.5)}
            for dtype in (torch.float32, torch.bfloat16):
                x = base.to(dtype).contiguous(memory_format=torch.channels_last)
                rtol_y = 1e-4 if dtype == torch.float32 else 2.0 ** -7
                route = fwd_plan(x).route
                over = {"y": 0.0, "mean": 0.0, "var_rel": 0.0}
                identical, repeatable = True, True
                for ga, be in affines.values():
                    y0, m0, i0 = instance_norm_fwd(x, ga, be, relu=relu)
                    cap = instance_norm_fwd(x, ga, be, relu=relu, capture=True)
                    cap2 = instance_norm_fwd(x, ga, be, relu=relu, capture=True)
                    y2, _, _ = instance_norm_apply_stats(x, ga, be, cap[1], cap[3], relu=relu)
                    torch.cuda.synchronize()
                    identical &= all(torch.equal(bits(a), bits(b)) for a, b in
                                     ((y0, cap[0]), (m0, cap[1]), (i0, cap[2]), (y0, y2)))
                    repeatable &= all(torch.equal(bits(a), bits(b)) for a, b in zip(cap, cap2))
                    y_r, _, _, v_r = instance_norm_fwd_reference(x.float(), ga, be,
                                                                 relu=relu, capture=True)
                    dy = (cap[0].float() - y_r).abs()
                    worst["capture"] = max(worst["capture"], dy.max().item())
                    over["y"] = max(over["y"], (dy / (1e-4 + rtol_y * y_r.abs())).max().item())
                    over["var_rel"] = max(over["var_rel"], (
                        (cap[3] - v_r).abs() / (v_r.abs() + 1e-6)).max().item())
                    for rm, rv in refs.values():
                        for blend in IN_STATS_BLENDS:
                            got = instance_norm_apply_stats(x, ga, be, rm, rv, blend=blend,
                                                            relu=relu)
                            again = instance_norm_apply_stats(x, ga, be, rm, rv,
                                                              blend=blend, relu=relu)
                            torch.cuda.synchronize()
                            want = instance_norm_apply_stats_reference(
                                x.float(), ga, be, rm, rv, blend=blend, relu=relu)
                            repeatable &= all(torch.equal(bits(a), bits(b))
                                              for a, b in zip(got, again) if a is not None)
                            dy = (got[0].float() - want[0]).abs()
                            worst["inject"] = max(worst["inject"], dy.max().item())
                            over["y"] = max(over["y"], (dy / (1e-4 + rtol_y * want[0].abs())
                                                        ).max().item())
                            if blend != 1.0:
                                over["mean"] = max(over["mean"], (
                                    (got[1] - want[1]).abs()
                                    / (1e-5 + 1e-4 * want[1].abs())).max().item())
                                over["var_rel"] = max(over["var_rel"], (
                                    (got[2] - want[2]).abs()
                                    / (want[2].abs() + 1e-6)).max().item())
                route_ok = large or route == SITE_ROUTE
                ok = (identical and repeatable and route_ok and over["y"] <= 1
                      and over["mean"] <= 1 and over["var_rel"] <= 1e-4)
                emit("in_stats_vs_plain", shape=[n, h, w, c], relu=relu,
                     dtype=str(dtype).replace("torch.", ""), route=route,
                     affines=list(affines), refs=list(refs), blends=list(IN_STATS_BLENDS),
                     capture_inject_equals_plain_bits=identical,
                     bitwise_repeatable=repeatable, y_err_over_tol=over["y"],
                     mean_err_over_tol=over["mean"], var_max_rel_err=over["var_rel"],
                     ok=ok)
                if not ok:
                    fail(f"capture/inject at {[n, h, w, c]} {dtype}: bits differ from the "
                         f"plain forward, repeats differ, or disagrees with plain ({over})")
    return worst


def phase_adain_in_vs_plain(seed: int) -> float:
    """The IN forward at the adain shape, relu4_1 of a 256x256 batch of
    ADAIN_BATCH: (8, 512, 32, 32), f32 and bf16, stable statistics, no
    ReLU, with the (N, C) affine of training (gamma = sigma_s > 0, beta =
    mu_s) and the (C,) affine of a cached or blended style, against the
    plain version at phase_kernel_vs_plain's tolerances; the one-launch
    route is asserted, each call runs twice and must repeat bit for bit.
    -> the largest |dy|."""
    import torch

    from fast_neural_style_transfer_tpu_torch.ops.cuda_norm import (
        fwd_plan,
        instance_norm_fwd,
        instance_norm_fwd_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(seed + 12)
    n, h, w, c = ADAIN_BATCH, 32, 32, 512
    base = torch.randn((n, c, h, w), generator=gen, device="cuda") * 2 + 0.5
    sigma = torch.rand((n, c), generator=gen, device="cuda") + 0.5
    mu = torch.randn((n, c), generator=gen, device="cuda")
    affines = {"sample": (sigma, mu), "channel": (sigma[0], mu[0])}
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        x = base.to(dtype).contiguous(memory_format=torch.channels_last)
        plan = fwd_plan(x)
        rtol_y = 1e-4 if dtype == torch.float32 else 2.0 ** -7
        for kind, (ga, be) in affines.items():
            with torch.inference_mode():
                y, mean, inv = instance_norm_fwd(x, ga, be)
                again = instance_norm_fwd(x, ga, be)
                torch.cuda.synchronize()
                y_r, mean_r, inv_r = instance_norm_fwd_reference(x.float(), ga, be)
            repeatable = all(torch.equal(bits(a), bits(b))
                             for a, b in zip((y, mean, inv), again))
            dy = (y.float() - y_r).abs()
            y_over = (dy / (1e-4 + rtol_y * y_r.abs())).max().item()
            m_over = ((mean - mean_r).abs() / (1e-5 + 1e-4 * mean_r.abs())).max().item()
            inv_rel = ((inv - inv_r).abs() / inv_r).max().item()
            worst = max(worst, dy.max().item())
            ok = (y_over <= 1 and m_over <= 1 and inv_rel <= 1e-4 and repeatable
                  and plan.route == SITE_ROUTE)
            emit("adain_in_vs_plain", shape=[n, h, w, c], dtype=str(dtype).replace(
                     "torch.", ""), affine=kind, route=plan.route,
                 chunks_per_sample=plan.chunks, blocks=plan.blocks,
                 y_max_abs_err=dy.max().item(), y_err_over_tol=y_over,
                 mean_err_over_tol=m_over, inv_max_rel_err=inv_rel, inv_rtol=1e-4,
                 bitwise_repeatable=repeatable, ok=ok)
            if not ok:
                fail(f"IN forward at the adain shape {[n, h, w, c]} {dtype} {kind} "
                     f"affine disagrees with plain, repeats with other bits or takes "
                     f"the wrong route ({plan.route})")
            del y, mean, inv, again, y_r, mean_r, inv_r
    return worst


VIDEO_FRAMES = 16
VIDEO_BATCH = 8  # the video CLI's default


def _panning_clip(n: int, size: int, seed: int) -> np.ndarray:
    """n seeded frames of size x size: a smooth image panned 3 px right
    and 2 px down a frame."""
    big = smooth_image(size + 2 * n + 8, size + 3 * n + 8, seed)
    return np.stack([big[2 * i:2 * i + size, 3 * i:3 * i + size] for i in range(n)])


def phase_video(seed: int) -> dict:
    """The video main path (ROADMAP row 11): the port's video CLI on the
    card with the trained checkpoint, bf16, batch 8, 256x256, frozen IN
    statistics (blend 1), on a seeded VIDEO_FRAMES-frame GIF made here;
    launch counters set to 0 just before and read just after: the reference
    frame's 14 capture launches (one-launch route) and 14 inject launches,
    then 14 inject launches per batch (the inject kernel), no plain one,
    and 13 reflect pads a forward (the reference frame's and each
    batch's). Then the frames through
    VideoStylizer on the card against the port's CPU f32 path: f32 max
    |du8| <= 1 at blend 1 and 0.5, bf16 SSIM >= 0.98 (every frame); the
    flicker of the stabilized against the plain stylizer; the u8 -> u8
    batch time of both (CUDA events, p50 of 20)."""
    import torch

    from fast_neural_style_transfer_tpu_torch.cli import video as video_cli
    from fast_neural_style_transfer_tpu_torch.infer import Stylizer
    from fast_neural_style_transfer_tpu_torch.infer.video import (
        VideoStylizer,
        flicker_score,
        read_frames,
        write_frames,
    )
    from fast_neural_style_transfer_tpu_torch.models import NUM_IN_SITES
    from fast_neural_style_transfer_tpu_torch.ops.conv import reflect_pad_hw
    from fast_neural_style_transfer_tpu_torch.ops.cuda_norm import instance_norm_fwd
    from fast_neural_style_transfer_tpu_torch.utils.ssim import ssim

    result = {}
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "clip.gif")
        write_frames(_panning_clip(VIDEO_FRAMES, 256, seed + 300), src)
        out = os.path.join(tmp, "out.gif")
        reset_launch_counts()
        t0 = time.perf_counter()
        summary = video_cli.main(["--model_path", str(CHECKPOINT), "--content", src,
                                  "--output", out, "--precision", "bf16",
                                  "--batch_size", str(VIDEO_BATCH)])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {"launches": instance_norm_fwd.launches,
                  "by_mode": dict(instance_norm_fwd.launches_by_mode),
                  "by_route": dict(instance_norm_fwd.launches_by_route),
                  "reflect_pad": reflect_pad_hw.launches}
        frames = read_frames(src)
        written = read_frames(out)
    batches = -(-VIDEO_FRAMES // VIDEO_BATCH)
    expected = {"capture": NUM_IN_SITES, "inject": NUM_IN_SITES * (batches + 1)}
    ok = (summary["frames"] == VIDEO_FRAMES and written.shape == frames.shape
          and nonzero(counts["by_mode"]) == expected
          and counts["reflect_pad"] == STYLIZER_PADS * (batches + 1)
          and nonzero(counts["by_route"]) == {SITE_ROUTE: expected["capture"],
                                              "inject": expected["inject"]})
    emit("video_cli", ok=ok, frames=VIDEO_FRAMES, batch=VIDEO_BATCH, size=[256, 256],
         precision="bf16", stats_blend=1.0, seconds=seconds, counts=counts,
         expected_by_mode=expected, summary=summary)
    if not ok:
        fail("video CLI phase")
    result["counts"] = counts

    cpu = {b: VideoStylizer.from_checkpoint(str(CHECKPOINT), device="cpu", stats_blend=b)
           .stylize_frames(frames, batch_size=VIDEO_BATCH) for b in (1.0, 0.5)}
    for precision, blend in (("f32", 1.0), ("f32", 0.5), ("bf16", 1.0)):
        card = VideoStylizer.from_checkpoint(str(CHECKPOINT), precision=precision,
                                             stats_blend=blend)
        got = card.stylize_frames(frames, batch_size=VIDEO_BATCH)
        du8 = int(np.abs(got.astype(int) - cpu[blend].astype(int)).max())
        score = min(ssim(g / 255.0, w / 255.0) for g, w in zip(got, cpu[blend]))
        ok = du8 <= 1 if precision == "f32" else score >= 0.98
        emit("video_vs_cpu", precision=precision, stats_blend=blend, frames=VIDEO_FRAMES,
             max_abs_du8=du8, min_ssim=score,
             criterion="max|du8|<=1" if precision == "f32" else "ssim>=0.98", ok=ok)
        if not ok:
            fail(f"video card vs CPU ({precision}, blend {blend})")

    stable = VideoStylizer.from_checkpoint(str(CHECKPOINT), precision="bf16")
    plain = VideoStylizer.from_checkpoint(str(CHECKPOINT), precision="bf16",
                                          stabilize=False)
    flicker = {"input": flicker_score(frames),
               "stabilized": flicker_score(stable.stylize_frames(frames)),
               "plain": flicker_score(plain.stylize_frames(frames))}
    x = torch.from_numpy(frames[:VIDEO_BATCH]).cuda()
    per_frame_in = Stylizer.from_checkpoint(str(CHECKPOINT), precision="bf16")
    times = {}
    for name, fn in (("stabilized_ms", lambda: stable.raw_forward(x)),
                     ("plain_ms", lambda: per_frame_in.raw_forward_u8(x))):
        samples = [cuda_ms(fn, iters=1, warmup=1 if not i else 0) for i in range(20)]
        times[name] = float(np.median(samples))
    emit("video_times", batch=VIDEO_BATCH, size=[256, 256], precision="bf16",
         flicker=flicker, **times,
         frames_per_s=VIDEO_BATCH / times["stabilized_ms"] * 1e3)
    result.update(flicker=flicker, times=times, kernel_times=video_kernel_times(seed))
    return result


def cold_ms(fn, flush, reps: int = 10) -> float:
    """Device time of one call of ``fn`` with the L2 cache emptied first:
    ``flush`` (1 GiB) is zeroed ahead of the start event, which keeps the
    device busy long enough for the host to enqueue the call behind it;
    the median of ``reps`` after one warm-up."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    samples = []
    for _ in range(reps + 1):
        flush.zero_()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end))
    return float(np.median(samples[1:]))


def video_kernel_times(seed: int) -> dict:
    """bf16 at B=8 over the 14 sites of a 256^2 forward (the video path):
    device time (CUDA-graph replay) of the capture call, the inject kernel
    (blend 1, a (1, C) reference, as the video path calls it) and the
    inject at blend 0.5 (the statistics kernel, its merge blending), each
    beside its plain version, the plain kernel forward and the bytes bound
    (read x once, write y once: the same for all three). The library call:
    F.instance_norm(x, ref_mean, ref_var, use_input_stats=False) (+F.relu)
    for blend 1; none computes capture's or blend 0.5's function in one
    call (null). The replay keeps a site's slab in the 50 MB L2 from one
    call to the next, so the kernels' and the library's times are also
    taken with the L2 emptied before each call (``cold_*``, cold_ms)."""
    import torch
    import torch.nn.functional as F

    from fast_neural_style_transfer_tpu_torch.ops.cuda_norm import (
        instance_norm_apply_stats,
        instance_norm_apply_stats_reference,
        instance_norm_fwd,
        instance_norm_fwd_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(seed + 12)
    n = VIDEO_BATCH
    keys = ("plain_kernel_ms", "capture_ms", "capture_plain_ms", "inject_ms",
            "inject_plain_ms", "inject_library_ms", "inject_blend_ms",
            "inject_blend_plain_ms", "cold_plain_kernel_ms", "cold_capture_ms",
            "cold_inject_ms", "cold_inject_library_ms", "cold_inject_blend_ms", "bound_ms")
    tot = dict.fromkeys(keys, 0.0)
    flush = torch.empty(1 << 28, dtype=torch.float32, device="cuda")
    with torch.inference_mode():
        for name, h, w, c, relu, count in SITES:
            x = (torch.randn((n, c, h, w), generator=gen, device="cuda") * 2 + 0.5)
            x = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
            g = torch.randn(c, generator=gen, device="cuda")
            b = torch.randn(c, generator=gen, device="cuda")
            rm = torch.randn((1, c), generator=gen, device="cuda")
            rv = torch.rand((1, c), generator=gen, device="cuda") + 0.5

            def library():
                y = F.instance_norm(x, running_mean=rm[0], running_var=rv[0], weight=g,
                                    bias=b, use_input_stats=False, eps=1e-5)
                return F.relu(y) if relu else y

            calls = {
                "plain_kernel_ms": lambda: instance_norm_fwd(x, g, b, relu=relu),
                "capture_ms": lambda: instance_norm_fwd(x, g, b, relu=relu, capture=True),
                "inject_ms": lambda: instance_norm_apply_stats(x, g, b, rm, rv, relu=relu),
                "inject_library_ms": library,
                "inject_blend_ms": lambda: instance_norm_apply_stats(
                    x, g, b, rm, rv, blend=0.5, relu=relu),
            }
            site = {
                "plain_kernel_ms": graph_ms(calls["plain_kernel_ms"]),
                "capture_ms": graph_ms(calls["capture_ms"]),
                "capture_plain_ms": graph_ms(lambda: instance_norm_fwd_reference(
                    x, g, b, relu=relu, capture=True)),
                "inject_ms": graph_ms(calls["inject_ms"]),
                "inject_plain_ms": graph_ms(lambda: instance_norm_apply_stats_reference(
                    x, g, b, rm, rv, relu=relu)),
                "inject_library_ms": graph_ms(library),
                "inject_blend_ms": graph_ms(calls["inject_blend_ms"]),
                "inject_blend_plain_ms": graph_ms(lambda: instance_norm_apply_stats_reference(
                    x, g, b, rm, rv, blend=0.5, relu=relu)),
                **{"cold_" + k: cold_ms(fn, flush) for k, fn in calls.items()},
            }
            site["bound_ms"], by = in_bound_ms(x.numel(), x.element_size())
            emit("video_times_site", site=name, shape=[n, h, w, c], dtype="bfloat16",
                 relu=relu, sites_per_forward=count, bound_by=by, **site)
            for k in keys:
                tot[k] += count * site[k]
    tot["bound_by"] = "bytes"
    emit("video_times_per_forward", batch=n, dtype="bfloat16", **tot,
         library_op="F.instance_norm(use_input_stats=False)(+F.relu)",
         inject_bound_share=tot["bound_ms"] / tot["inject_ms"],
         capture_bound_share=tot["bound_ms"] / tot["capture_ms"],
         cold_inject_bound_share=tot["bound_ms"] / tot["cold_inject_ms"])
    del flush
    return tot


ADAIN_STEPS = 10
ADAIN_BATCH = 8  # the AdaIN training CLI's default


def _one_adain_step(device: str, seed: int, size: int = 128, batch: int = 2):
    """One f32 AdaIN step from the seeded decoder, the seeded random VGG and
    seeded content and style batches -> (loss, grads, grad_norm, params
    before, params after, step), on the CPU."""
    import torch

    from fast_neural_style_transfer_tpu_torch.core.dtypes import Precision
    from fast_neural_style_transfer_tpu_torch.models.adain import make_decoder
    from fast_neural_style_transfer_tpu_torch.models.vgg_weights import make_vgg, random_params
    from fast_neural_style_transfer_tpu_torch.train.adain import (
        adain_loss_fn,
        create_adain_train_state,
        make_adain_train_step,
    )
    from fast_neural_style_transfer_tpu_torch.train.step import exact_f32

    prec = Precision.f32()
    exact_f32(torch.device(device), prec)
    torch.manual_seed(seed)
    dec = make_decoder(None, device)
    vgg = make_vgg(random_params(seed), device)
    imgs = lambda s0: torch.from_numpy(np.stack(
        [smooth_image(size, size, seed=s0 + i) for i in range(batch)])).to(device)
    content, style = imgs(30), imgs(60)
    cpu = lambda ts: [t.detach().float().cpu().clone() for t in ts]
    params = list(dec.parameters())
    before = cpu(params)
    total, _ = adain_loss_fn(dec, vgg, content, style, 10.0, precision=prec)
    grads = torch.autograd.grad(total, params)
    state = create_adain_train_state(dec)
    m = make_adain_train_step(lr_decay=5e-5)(state, vgg, content, style)
    return (float(m["loss"]), cpu(grads), float(m["grad_norm"]), before,
            cpu(dec.parameters()), state.step)


def adain_parity(seed: int) -> None:
    """One f32 AdaIN step (128x128, B=2, lr 1e-4) on the card against the
    port's CPU step: phase_train_parity's bounds (loss and gradient norm
    1e-4 relative, every gradient element within 1e-3 of the largest,
    updated params within 2 lr, and within 1e-3 lr where the gradient is at
    least 1e-4: there is no clip, so Adam's u(g) = g / (|g| + 1e-8) swings
    only where |g| is within a few hundred 1e-8 of zero)."""
    lr = 1e-4
    card, cpu = _one_adain_step("cuda", seed), _one_adain_step("cpu", seed)
    loss_rel = abs(card[0] - cpu[0]) / abs(cpu[0])
    gmax = max(g.abs().max().item() for g in cpu[1])
    grad_err = max((a - b).abs().max().item() for a, b in zip(card[1], cpu[1])) / gmax
    norm_rel = abs(card[2] - cpu[2]) / cpu[2]
    dp = [(a - b).abs() / lr for a, b in zip(card[4], cpu[4])]
    off = [d > 1e-3 for d in dp]
    g_off = max((g.abs()[o].max().item() for g, o in zip(cpu[1], off) if o.any()),
                default=0.0)
    dp_max = max(d.max().item() for d in dp)
    ok = (loss_rel <= 1e-4 and norm_rel <= 1e-4 and grad_err <= 1e-3 and dp_max <= 2
          and g_off < 1e-4 and card[5] == cpu[5] == 1)
    emit("adain_parity", ok=ok, size=[128, 128], batch=2, precision="f32",
         loss_card=card[0], loss_cpu=cpu[0], loss_rel_err=loss_rel,
         grad_norm_rel_err=norm_rel, grad_max_abs_err_over_max_grad=grad_err,
         param_max_abs_err_over_lr=dp_max, largest_grad_where_off=g_off,
         steps=[card[5], cpu[5]])
    if not ok:
        fail("AdaIN card-vs-CPU step parity")


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def adain_serve(decoder: str, style: str) -> dict:
    """fnst-serve --adain-decoder (the port's server module, its own
    process, bf16 by default, on the card by default) answers 2 bursts of 8
    concurrent requests (``serve_process``); one PNG reply against
    ArbitraryStylizer on the card here at batch 1 (SSIM >= 0.98: the server
    batches up to 8 and cuDNN may pick other kernels per batch)."""
    from PIL import Image

    from fast_neural_style_transfer_tpu_torch.infer.adain import ArbitraryStylizer
    from fast_neural_style_transfer_tpu_torch.models.adain import load_decoder
    from fast_neural_style_transfer_tpu_torch.models.vgg_weights import random_params
    from fast_neural_style_transfer_tpu_torch.utils.image_io import decode_image
    from fast_neural_style_transfer_tpu_torch.utils.ssim import ssim

    img = smooth_image(256, 256, seed=88)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    served = serve_process(["--adain-decoder", decoder, "--style", style, "--alpha", "0.8"],
                           buf.getvalue(), "image/png", bursts=2, per_burst=8)
    replies, health = served["replies"], served["healthz"]
    got = np.asarray(Image.open(io.BytesIO(replies[0][1])).convert("RGB"))
    want = ArbitraryStylizer(load_decoder(decoder), random_params(0), precision="bf16"
                             ).set_style_u8(decode_image(style)).stylize_u8(img, alpha=0.8)
    score = ssim(got / 255.0, want / 255.0)
    ok = (all(r[0] == 200 for r in replies) and health["family"] == "adain"
          and got.shape == img.shape and score >= 0.98)
    result = {"ready_seconds": served["ready_seconds"], "requests": len(replies),
              "p50_ms": float(np.median([r[2] for r in replies])),
              "healthz": health, "ssim_vs_in_process": score,
              "exit_code": served["exit_code"]}
    emit("adain_serve", ok=ok, **result)
    if not ok:
        fail("fnst-serve --adain-decoder")
    return result


def phase_adain(seed: int) -> dict:
    """The AdaIN main path (ROADMAP row 12): the AdaIN training CLI on the
    card for ADAIN_STEPS steps at batch 8, 256x256, f32 (the CLI's
    defaults), the seeded random VGG, on seeded content and style folders;
    launch counters set to 0 just before and read just after: one IN
    forward a step (adain: (B, C) affine, the one-launch kernel) and one
    conv1_1 dx a step (the encode of the decoder's output, the tap-packed
    kernel), and one reflect-pad launch a step (the decoder's first pad,
    of the AdaIN output, which needs no gradient). Then the card's step time at B=8 (f32 and bf16, CUDA events,
    p50 of 8 after 2 warm-ups), one f32 step card vs CPU (adain_parity),
    ArbitraryStylizer with the trained decoder on the card against the
    CPU f32 path (f32 max |du8| <= 1 at alpha 1 and 0.7, bf16 SSIM >= 0.98;
    one IN launch a forward, a (C,) affine, 9 reflect pads), the stylize CLI with two
    blended styles on the card against --cpu (f32 max |du8| <= 1, one IN
    launch, a (C,) affine), and fnst-serve --adain-decoder
    (adain_serve)."""
    import torch
    from PIL import Image

    from fast_neural_style_transfer_tpu_torch.cli import adain as adain_cli
    from fast_neural_style_transfer_tpu_torch.infer.adain import ArbitraryStylizer
    from fast_neural_style_transfer_tpu_torch.models.adain import load_decoder, make_decoder
    from fast_neural_style_transfer_tpu_torch.models.vgg_weights import make_vgg, random_params
    from fast_neural_style_transfer_tpu_torch.ops.conv import reflect_pad_hw
    from fast_neural_style_transfer_tpu_torch.ops.cuda_conv import conv2d_same_dx
    from fast_neural_style_transfer_tpu_torch.ops.cuda_norm import (
        instance_norm_bwd,
        instance_norm_fwd,
    )
    from fast_neural_style_transfer_tpu_torch.train.adain import (
        create_adain_train_state,
        make_adain_train_step,
    )
    from fast_neural_style_transfer_tpu_torch.utils.image_io import decode_image
    from fast_neural_style_transfer_tpu_torch.utils.ssim import ssim

    result = {}
    with tempfile.TemporaryDirectory() as tmp:
        folders = {}
        for kind, s0 in (("content", 2000), ("style", 3000)):
            folders[kind] = os.path.join(tmp, kind)
            os.makedirs(folders[kind])
            for i in range(2 * ADAIN_BATCH):
                Image.fromarray(smooth_image(256 + 16 * (i % 3), 256 + 8 * (i % 4),
                                             seed=s0 + i)).save(
                    os.path.join(folders[kind], f"{i:03d}.jpg"), quality=92)
        out = os.path.join(tmp, "out")
        reset_launch_counts()
        conv2d_same_dx.launches = 0
        conv2d_same_dx.launches_by_route = dict.fromkeys(conv2d_same_dx.launches_by_route, 0)
        t0 = time.perf_counter()
        final = adain_cli.main(["train", "--content_dir", folders["content"],
                                "--style_dir", folders["style"], "--output_dir", out,
                                "--total_steps", str(ADAIN_STEPS), "--seed", str(seed)])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {"instance_norm_fwd": {"launches": instance_norm_fwd.launches,
                                        "by_route": dict(instance_norm_fwd.launches_by_route),
                                        "by_affine": dict(instance_norm_fwd.launches_by_affine),
                                        "by_mode": dict(instance_norm_fwd.launches_by_mode)},
                  "instance_norm_bwd": {"launches": instance_norm_bwd.launches},
                  "conv2d_same_dx": {"launches": conv2d_same_dx.launches,
                                     "by_route": dict(conv2d_same_dx.launches_by_route)},
                  "reflect_pad": {"launches": reflect_pad_hw.launches}}
        with open(os.path.join(out, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        fwd = counts["instance_norm_fwd"]
        ok = (fwd["launches"] == ADAIN_STEPS
              and nonzero(fwd["by_route"]) == {SITE_ROUTE: ADAIN_STEPS}
              and nonzero(fwd["by_affine"]) == {"sample": ADAIN_STEPS}
              and counts["instance_norm_bwd"]["launches"] == 0
              and counts["conv2d_same_dx"] == {"launches": ADAIN_STEPS, "by_route": {
                  "tap_packed": ADAIN_STEPS, "tiled": 0}}
              and counts["reflect_pad"]["launches"] == ADAIN_STEPS
              and records and records[-1]["step"] == ADAIN_STEPS
              and all(r["skipped_nonfinite"] == 0 and np.isfinite(r["loss"])
                      for r in records)
              and os.path.basename(final) == "adain_decoder_final.npz")
        emit("adain_training", ok=ok, steps=ADAIN_STEPS, batch=ADAIN_BATCH, size=[256, 256],
             precision="f32", seconds=seconds, steps_per_s=ADAIN_STEPS / seconds,
             counts=counts, metrics=records)
        if not ok:
            fail("AdaIN training phase")
        result["counts"] = counts

        # step time at the CLI's shape
        u8 = lambda s0: torch.from_numpy(np.stack(
            [smooth_image(256, 256, seed=s0 + i) for i in range(ADAIN_BATCH)])).cuda()
        content, style = u8(4000), u8(5000)
        vgg = make_vgg(random_params(seed), "cuda")
        result["step_ms"] = {}
        for precision in ("f32", "bf16"):
            from fast_neural_style_transfer_tpu_torch.core.dtypes import canonical_compute_dtype

            prec = canonical_compute_dtype(precision)
            state = create_adain_train_state(make_decoder(load_decoder(final), "cuda"))
            step = make_adain_train_step(precision=prec, lr_decay=5e-5)
            for _ in range(2):
                step(state, vgg, content, style)
            samples = [cuda_ms(lambda: step(state, vgg, content, style), iters=1, warmup=0)
                       for _ in range(8)]
            p50 = float(np.median(samples))
            result["step_ms"][precision] = p50
            emit("adain_step_time", precision=precision, batch=ADAIN_BATCH, size=[256, 256],
                 p50_ms=p50, min_ms=float(np.min(samples)),
                 steps_per_s=1e3 / p50, images_per_s=ADAIN_BATCH / p50 * 1e3,
                 peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
            del state, step
        adain_parity(seed)

        style_path = os.path.join(folders["style"], "000.jpg")
        style_u8 = decode_image(style_path)
        img = smooth_image(256, 256, seed=89)
        dec_sd = result["decoder"] = load_decoder(final)
        cpu = ArbitraryStylizer(dec_sd, random_params(seed), device="cpu"
                                ).set_style_u8(style_u8)
        for precision, alpha in (("f32", 1.0), ("f32", 0.7), ("bf16", 1.0)):
            card = ArbitraryStylizer(dec_sd, random_params(seed), precision=precision
                                     ).set_style_u8(style_u8)
            reset_launch_counts()
            got = card.stylize_u8(img, alpha=alpha)
            by_affine = nonzero(instance_norm_fwd.launches_by_affine)
            pads = reflect_pad_hw.launches
            result.setdefault("stylizer_pad_launches", []).append(pads)
            want = cpu.stylize_u8(img, alpha=alpha)
            du8 = int(np.abs(got.astype(int) - want.astype(int)).max())
            score = ssim(got / 255.0, want / 255.0)
            ok = (by_affine == {"channel": 1} and pads == DECODER_PADS
                  and (du8 <= 1 if precision == "f32" else score >= 0.98))
            emit("adain_stylizer_vs_cpu", precision=precision, alpha=alpha,
                 max_abs_du8=du8, ssim=score, launches_by_affine=by_affine,
                 pad_launches=pads,
                 output_std_u8=float(want.std()),
                 criterion="max|du8|<=1" if precision == "f32" else "ssim>=0.98", ok=ok)
            if not ok:
                fail(f"AdaIN stylizer card vs CPU ({precision}, alpha {alpha})")
        # the stylize CLI (stylize_arbitrary, folded moments): two styles
        # blended 0.3 / 0.7, alpha 0.8, f32, the card against --cpu
        content_path = os.path.join(tmp, "content.png")
        Image.fromarray(smooth_image(256, 256, seed=90)).save(content_path)
        outs, by_affine = {}, None
        for flags in ((), ("--cpu",)):
            outs[flags] = os.path.join(tmp, f"stylized{len(flags)}.png")
            reset_launch_counts()
            adain_cli.main(["stylize", "--decoder", final, "--content_image", content_path,
                            "--style_image", style_path,
                            os.path.join(folders["style"], "001.jpg"),
                            "--style_blend", "0.3", "0.7", "--alpha", "0.8",
                            "--output", outs[flags], *flags])
            if not flags:
                by_affine = nonzero(instance_norm_fwd.launches_by_affine)
        got, want = (np.asarray(Image.open(outs[f]).convert("RGB")) for f in outs)
        du8 = int(np.abs(got.astype(int) - want.astype(int)).max())
        ok = by_affine == {"channel": 1} and got.shape == want.shape and du8 <= 1
        emit("adain_stylize_cli_vs_cpu", precision="f32", alpha=0.8,
             style_blend=[0.3, 0.7], max_abs_du8=du8, launches_by_affine=by_affine,
             criterion="max|du8|<=1", ok=ok)
        if not ok:
            fail("AdaIN stylize CLI card vs --cpu")
        result["serve"] = adain_serve(final, style_path)
    result["kernel_times"] = adain_kernel_times(seed)
    return result


def adain_kernel_times(seed: int) -> dict:
    """At the AdaIN training shape (B=8, 256x256), f32 and bf16: the
    conv1_1 dx kernel (tap-packed), its plain version, cuDNN's backward-data
    call and the bound (train_kernel_times' accounting); and the adain IN
    forward at relu4_1 (8, 32, 32, 512) with a (B, C) affine, its plain
    version and the bound (F.instance_norm takes no per-sample affine:
    its (C,) call is the yardstick)."""
    import torch
    import torch.nn.functional as F

    from fast_neural_style_transfer_tpu_torch.ops.cuda_conv import (
        conv2d_same_dx,
        conv2d_same_dx_reference,
        conv_dx_plan,
    )
    from fast_neural_style_transfer_tpu_torch.ops.cuda_norm import (
        instance_norm_fwd,
        instance_norm_fwd_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(seed + 13)
    n = ADAIN_BATCH
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        g = torch.randn((n, 64, 256, 256), generator=gen, device="cuda").to(dtype)
        g = g.contiguous(memory_format=torch.channels_last)
        wt = (torch.randn((64, 3, 3, 3), generator=gen, device="cuda") * 0.1).to(dtype)
        conv = {
            "ms": graph_ms(lambda: conv2d_same_dx(g, wt)),
            "plain_ms": graph_ms(lambda: conv2d_same_dx_reference(g, wt)),
            "library_ms": graph_ms(lambda: torch.nn.grad.conv2d_input(
                (n, 3, 256, 256), wt, g, padding=1)),
        }
        conv["bound_ms"], conv["bound_by"] = bound(
            g.numel() * g.element_size() + n * 3 * 256 * 256 * g.element_size(),
            2 * 27 * 64 * n * 256 * 256, dname)
        emit("adain_times_conv_dx", dtype=dname, shape=[n, 256, 256], c_in=3, c_out=64,
             route=conv_dx_plan(g, wt).route, **conv,
             library_op="torch.nn.grad.conv2d_input (cuDNN)",
             bound_share=conv["bound_ms"] / conv["ms"])
        x = (torch.randn((n, 512, 32, 32), generator=gen, device="cuda") * 2 + 0.5)
        x = x.to(dtype).contiguous(memory_format=torch.channels_last)
        sg = torch.rand((n, 512), generator=gen, device="cuda") + 0.5
        mu = torch.randn((n, 512), generator=gen, device="cuda")
        with torch.inference_mode():
            site = {
                "ms": graph_ms(lambda: instance_norm_fwd(x, sg, mu)),
                "plain_ms": graph_ms(lambda: instance_norm_fwd_reference(x, sg, mu)),
                "library_ms": graph_ms(lambda: F.instance_norm(x, weight=sg[0], bias=mu[0],
                                                               eps=1e-5)),
            }
        site["bound_ms"], site["bound_by"] = in_bound_ms(x.numel(), x.element_size())
        emit("adain_times_in_fwd", dtype=dname, shape=[n, 32, 32, 512], affine="(B, C)",
             library_op="F.instance_norm, (C,) affine", **site)
        out[dname] = {"conv_dx": conv, "in_fwd": site}
    return out


# -- slice 9: export and int8 inference ----------------------------------------


def serve_process(flags: list, body: bytes, content_type: str, bursts: int,
                  per_burst: int) -> dict:
    """fnst-serve (the port's server module) with ``flags`` in its own
    process on a free port: wait for its ready banner, post ``bursts``
    bursts of ``per_burst`` concurrent requests of ``body``, read
    /healthz, then stop it with SIGTERM (its drain) and wait for it.
    Returns the ready time, the replies (status, bytes, ms), /healthz and
    the exit code."""
    import signal as signal_mod

    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "fast_neural_style_transfer_tpu_torch.serve", *flags,
         "--host", "127.0.0.1", "--port", str(port)],
        cwd=str(REPO), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        t0 = time.perf_counter()
        banner = ""
        while "fnst-serve:" not in banner:
            line = proc.stdout.readline()
            if not line or time.perf_counter() - t0 > 300:
                fail(f"fnst-serve {' '.join(flags)} did not start: {banner[-2000:]}")
            banner += line
        ready_s = time.perf_counter() - t0

        def post(_):
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
            try:
                t = time.perf_counter()
                conn.request("POST", "/stylize?format=png", body=body,
                             headers={"Content-Type": content_type})
                resp = conn.getresponse()
                return resp.status, resp.read(), (time.perf_counter() - t) * 1e3
            finally:
                conn.close()

        replies = []
        for _ in range(bursts):
            with ThreadPoolExecutor(max_workers=per_burst) as pool:
                replies += list(pool.map(post, range(per_burst)))
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        conn.close()
    finally:
        proc.send_signal(signal_mod.SIGTERM)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
    return {"ready_seconds": ready_s, "replies": replies, "healthz": health,
            "exit_code": proc.returncode}


class capture_calls:
    """Within the block, record the arguments of every call of
    ``module.name`` (the call still runs); restores the attribute after."""

    def __init__(self, module, name: str):
        self.module, self.name, self.calls = module, name, []

    def __enter__(self):
        self.real = getattr(self.module, self.name)

        def spy(*args, **kw):
            self.calls.append((args, kw))
            return self.real(*args, **kw)

        setattr(self.module, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def in_vs_plain(calls: list, path: str) -> float:
    """The IN forward kernel against its plain version on the inputs a path
    gave ``ops/norm.py::instance_norm`` (float32, (C,) affines), with
    phase_kernel_vs_plain's f32 tolerance |dy| <= 1e-4 + 1e-4|y|. Returns
    the largest |dy|; these launches are not the path's."""
    import torch

    from fast_neural_style_transfer_tpu_torch.ops.cuda_norm import (
        instance_norm_fwd,
        instance_norm_fwd_reference,
    )

    worst, over = 0.0, 0.0
    with torch.inference_mode():
        for (x, gamma, beta), kw in calls:
            y, _, _ = instance_norm_fwd(x, gamma, beta, **kw)
            torch.cuda.synchronize()
            y_r, _, _ = instance_norm_fwd_reference(x, gamma, beta, **kw)
            dy = (y - y_r).abs()
            worst = max(worst, dy.max().item())
            over = max(over, (dy / (1e-4 + 1e-4 * y_r.abs())).max().item())
    ok = over <= 1 and len(calls) > 0
    emit("in_fwd_vs_plain_on_path", path=path, sites=len(calls),
         shapes=sorted({tuple(c[0][0].shape) for c in calls}), y_max_abs_err=worst,
         y_err_over_tol=over, tol="1e-4 + 1e-4|y|", ok=ok)
    if not ok:
        fail(f"IN kernel against plain on the {path} path")
    return worst


def _nchw_network(img_u8: np.ndarray):
    """(H, W, 3) or (N, H, W, 3) uint8 -> network-space NCHW f32 on the card
    (``u8_to_network``, the Stylizer's own normalization)."""
    import torch

    from fast_neural_style_transfer_tpu_torch.utils.image_io import u8_to_network

    x = torch.from_numpy(np.array(img_u8 if img_u8.ndim == 4 else img_u8[None])).cuda()
    return u8_to_network(x).permute(0, 3, 1, 2)


def _u8(y_nchw) -> np.ndarray:
    from fast_neural_style_transfer_tpu_torch.utils.image_io import network_to_u8

    return network_to_u8(y_nchw.permute(0, 2, 3, 1)).cpu().numpy()


def _du8(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.abs(a.astype(int) - b.astype(int)).max())


def ssim_card(xs: np.ndarray, ys: np.ndarray) -> np.ndarray:
    """Per-image SSIM of two uint8 (N, H, W, C) batches: utils/ssim.py's
    formula (11x11 Gaussian window, sigma 1.5, VALID, on [0, 1], per
    channel, then the channel mean) in float64 on the card; the numpy
    version takes about half a second a 256x256 image."""
    import torch
    import torch.nn.functional as F

    ax = torch.arange(11, dtype=torch.float64) - 5.0
    g = torch.exp(-0.5 * (ax / 1.5) ** 2)
    k = torch.outer(g, g)
    k = (k / k.sum()).view(1, 1, 11, 11).cuda()
    a, b = (torch.from_numpy(np.asarray(v)).cuda().double().permute(0, 3, 1, 2) / 255.0
            for v in (xs, ys))
    n, c, h, w = a.shape
    blur = lambda t: F.conv2d(t.reshape(n * c, 1, h, w), k).view(n, c, h - 10, w - 10)
    mu_a, mu_b = blur(a), blur(b)
    var_a, var_b = blur(a * a) - mu_a ** 2, blur(b * b) - mu_b ** 2
    cov = blur(a * b) - mu_a * mu_b
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)
         / ((mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2)))
    return s.mean(dim=(2, 3)).mean(dim=1).cpu().numpy()


def p50_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of ``reps`` single calls timed with CUDA events."""
    samples = [cuda_ms(fn, iters=1, warmup=warmup if i == 0 else 0) for i in range(reps)]
    return float(np.median(samples))


def seeded_adain_decoder(tmp: str, seed: int) -> str:
    """The AdaIN decoder the export phase ships when the ``adain`` phase did
    not run (``--phases export``): the AdaIN training CLI from its seeded
    init, with the seeded random VGG, for ADAIN_STEPS steps at batch 4,
    128x128 (enough for an output with an image's spread; the seeded init's
    is nearly flat). Returns the decoder .npz."""
    from PIL import Image

    from fast_neural_style_transfer_tpu_torch.cli import adain as adain_cli

    folders = {}
    for kind, s0 in (("content", 6000), ("style", 7000)):
        folders[kind] = os.path.join(tmp, kind)
        os.makedirs(folders[kind])
        for i in range(8):
            Image.fromarray(smooth_image(160, 160, seed=s0 + i)).save(
                os.path.join(folders[kind], f"{i:03d}.jpg"), quality=92)
    return adain_cli.main(["train", "--content_dir", folders["content"], "--style_dir",
                           folders["style"], "--output_dir", os.path.join(tmp, "adain"),
                           "--total_steps", str(ADAIN_STEPS), "--batch_size", "4",
                           "--image_size", "128", "128", "--seed", str(seed)])


def phase_export(seed: int, adain_decoder=None) -> dict:
    """The export main path (ROADMAP row 9): the port's export CLI on the
    in-repo trained checkpoint writes ONNX (static 1x3x256x256 and
    --onnx-dynamic), TorchScript (its check forward on the card), the
    reference .pth and a hub directory. On the card, against the f32
    Stylizer (TF32 off, no bucket padding): the ONNX runtime at 256x256
    (static graph) and 200x300 (dynamic), the TorchScript archive loaded
    with map_location="cuda", both max |du8| <= 1; the ONNX runtime runs the
    IN forward kernel at its 14 InstanceNormalization nodes (counts set to 0
    just before each forward, read just after), held against the plain
    version on the inputs it was given. The hub's pytorch_model.pth holds
    the checkpoint's weights bit for bit and, served by
    Stylizer.from_checkpoint, gives the checkpoint's output bit for bit on
    the CPU and on the card (cuDNN deterministic).
    AdaIN: the decoder the ``adain`` phase trained (``adain_decoder``, its
    state_dict; trained here by ``seeded_adain_decoder`` when that phase did
    not run), the seeded random VGG; cli/adain.py export writes the two-input ONNX and
    TorchScript and a baked-style ONNX; the runtime and the archive on the
    card against ArbitraryStylizer f32, max |du8| <= 1. Then the ONNX
    runtime's and the archive's B=1 256x256 f32 forward (CUDA events, p50)."""
    import torch
    from PIL import Image

    from fast_neural_style_transfer_tpu_torch.cli import adain as adain_cli
    from fast_neural_style_transfer_tpu_torch.export import cli as export_cli
    from fast_neural_style_transfer_tpu_torch.export import onnx_runtime
    from fast_neural_style_transfer_tpu_torch.infer import Stylizer
    from fast_neural_style_transfer_tpu_torch.infer.adain import ArbitraryStylizer
    from fast_neural_style_transfer_tpu_torch.models import NUM_IN_SITES
    from fast_neural_style_transfer_tpu_torch.models.adain import load_decoder, save_decoder_npz
    from fast_neural_style_transfer_tpu_torch.models.vgg_weights import random_params
    from fast_neural_style_transfer_tpu_torch.ops.cuda_norm import instance_norm_fwd
    from fast_neural_style_transfer_tpu_torch.utils.image_io import decode_image

    result = {"launches": []}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        art = {k: os.path.join(tmp, k) for k in ("m.onnx", "m_dyn.onnx", "m.pt", "m.pth", "hub")}
        export_cli.main(["--model", str(CHECKPOINT), "--onnx", art["m.onnx"], "--torchscript",
                         art["m.pt"], "--pth", art["m.pth"], "--hub-dir", art["hub"]])
        export_cli.main(["--model", str(CHECKPOINT), "--onnx", art["m_dyn.onnx"],
                         "--onnx-dynamic"])
        emit("export_cli", seconds=time.perf_counter() - t0,
             bytes={k: os.path.getsize(v) for k, v in art.items() if k != "hub"},
             hub=sorted(os.listdir(art["hub"])))
        params = Stylizer.load_params(str(CHECKPOINT))
        ref = Stylizer(params, precision="f32", bucket_multiple=4)
        archive = torch.jit.load(art["m.pt"], map_location="cuda")
        worst_du8, worst_in = 0, 0.0
        for (h, w), graph in (((256, 256), "m.onnx"), ((200, 300), "m_dyn.onnx")):
            img = smooth_image(h, w, seed=seed + 300 + h)
            x = _nchw_network(img)
            with open(art[graph], "rb") as f:
                data = f.read()
            want = ref.stylize_u8(img)
            reset_launch_counts()
            with capture_calls(onnx_runtime, "instance_norm") as cap:
                (out,) = onnx_runtime.run_model(data, {"input_image": x})
            torch.cuda.synchronize()
            launches = instance_norm_fwd.launches
            by_route = nonzero(instance_norm_fwd.launches_by_route)
            got = _u8(out)[0]
            with torch.inference_mode():
                ts_got = _u8(archive(x))[0]
            du8, ts_du8 = _du8(got, want), _du8(ts_got, want)
            worst_in = max(worst_in, in_vs_plain(cap.calls, f"onnx_runtime {h}x{w}"))
            ok = (got.shape == want.shape == (h, w, 3) and du8 <= 1 and ts_du8 <= 1
                  and launches == NUM_IN_SITES and by_route == {SITE_ROUTE: NUM_IN_SITES}
                  and all(kw.get("relu") is None for _, kw in cap.calls))
            emit("export_vs_stylizer", seconds=time.perf_counter() - t0, graph=graph, size=[h, w],
                 onnx_max_abs_du8=du8, torchscript_max_abs_du8=ts_du8,
                 in_fwd_launches=launches, launches_by_route=by_route,
                 criterion="max|du8|<=1; 14 IN launches", ok=ok)
            if not ok:
                fail(f"export check at {h}x{w}")
            worst_du8 = max(worst_du8, du8, ts_du8)
            result["launches"].append(launches)
        # the hub's weights are the checkpoint's bit for bit, and serve its
        # output bit for bit: on the CPU, and on the card with cuDNN held to
        # its deterministic convolution algorithms. With cuDNN's default
        # choice the checkpoint's own Stylizer, called twice, is printed
        # beside it (cuDNN may pick a conv algorithm whose sums are not
        # repeatable)
        img = smooth_image(256, 256, seed=seed + 310)
        hub_pth = os.path.join(art["hub"], "pytorch_model.pth")
        hub_sd = Stylizer.load_params(hub_pth)
        same_weights = list(hub_sd) == list(params) and all(
            torch.equal(hub_sd[k], params[k]) for k in params)
        served = {(dev, path): Stylizer.from_checkpoint(path, precision="f32", device=dev)
                  for dev in ("cpu", "cuda") for path in (hub_pth, str(CHECKPOINT))}
        outs = {key: sty.stylize_u8(img) for key, sty in served.items()
                if key[0] == "cpu"}
        ckpt_card = served["cuda", str(CHECKPOINT)]
        repeat_du8 = _du8(ckpt_card.stylize_u8(img), ckpt_card.stylize_u8(img))
        torch.backends.cudnn.deterministic = True
        try:
            outs.update({key: sty.stylize_u8(img) for key, sty in served.items()
                         if key[0] == "cuda"})
        finally:
            torch.backends.cudnn.deterministic = False
        identical = {dev: bool(np.array_equal(outs[dev, hub_pth], outs[dev, str(CHECKPOINT)]))
                     for dev in ("cpu", "cuda")}
        ok = same_weights and all(identical.values())
        emit("export_hub_pth", seconds=time.perf_counter() - t0,
             weights_bit_identical=same_weights,
             output_bit_identical=identical, cudnn_deterministic_on_card=True,
             card_default_cudnn_repeat_max_abs_du8=repeat_du8, ok=ok)
        if not ok:
            fail("the hub's pytorch_model.pth does not serve the checkpoint's output")
        del served, ckpt_card

        # times: B=1 256x256 f32 forward, device p50 between CUDA events
        x = _nchw_network(smooth_image(256, 256, seed=seed + 320))
        with open(art["m.onnx"], "rb") as f:
            data = f.read()
        u8 = torch.from_numpy(smooth_image(256, 256, seed=seed + 320)[None]).cuda()
        with torch.inference_mode():
            result["times"] = {
                "onnx_runtime_ms": p50_ms(lambda: onnx_runtime.run_model(data, {"input_image": x})),
                "torchscript_ms": p50_ms(lambda: archive(x)),
                "stylizer_f32_ms": p50_ms(lambda: ref.raw_forward_u8(u8)),
            }
        emit("export_times", seconds=time.perf_counter() - t0,
             batch=1, size=[256, 256], precision="f32", **result["times"],
             note="onnx_runtime_ms includes parsing the graph and moving its "
                  "initializers to the card on every call; stylizer_f32_ms is "
                  "the u8 -> u8 forward")

        # AdaIN exports
        if adain_decoder is None:
            decoder = seeded_adain_decoder(tmp, seed)
        else:
            decoder = os.path.join(tmp, "adain_decoder.npz")
            save_decoder_npz(adain_decoder, decoder)
        style_path = os.path.join(tmp, "style.png")
        Image.fromarray(smooth_image(256, 256, seed=7100)).save(style_path)
        a_onnx, a_pt, a_baked = (os.path.join(tmp, n) for n in
                                 ("adain.onnx", "adain.pt", "adain_baked.onnx"))
        adain_cli.main(["export", "--decoder", decoder, "--onnx", a_onnx, "--torchscript", a_pt])
        adain_cli.main(["export", "--decoder", decoder, "--onnx", a_baked,
                        "--style_image", style_path])
        style_u8 = decode_image(style_path)
        sty = ArbitraryStylizer(load_decoder(decoder), random_params(0), precision="f32"
                                ).set_style_u8(style_u8)
        img = smooth_image(256, 256, seed=seed + 330)
        want = sty.stylize_u8(img)
        c, s = _nchw_network(img), _nchw_network(style_u8)
        outs = {}
        with open(a_onnx, "rb") as f:
            (outs["onnx_two_input"],) = onnx_runtime.run_model(
                f.read(), {"content_image": c, "style_image": s})
        with open(a_baked, "rb") as f:
            (outs["onnx_baked"],) = onnx_runtime.run_model(f.read(), {"content_image": c})
        with torch.inference_mode():
            outs["torchscript"] = torch.jit.load(a_pt, map_location="cuda")(c, s)
        du8 = {k: _du8(_u8(v)[0], want) for k, v in outs.items()}
        ok = all(v <= 1 for v in du8.values())
        emit("export_adain_vs_stylizer", seconds=time.perf_counter() - t0,
             size=[256, 256], max_abs_du8=du8,
             output_std_u8=float(want.std()), criterion="max|du8|<=1", ok=ok)
        if not ok:
            fail("AdaIN export check")
        worst_du8 = max([worst_du8, *du8.values()])
    result.update(max_abs_du8=worst_du8, in_max_abs_err=worst_in)
    return result


INT8_BATCHES = (1, 8)


def _library_in(x, gamma, beta, *, relu: bool):
    import torch.nn.functional as F

    y = F.instance_norm(x, weight=gamma, bias=beta, eps=1e-5)
    return F.relu(y) if relu else y


def int8_stage_times(sty, x_u8) -> dict:
    """Device time of one int8 u8 forward split by stage: each stage's
    calls are recorded during one forward and replayed alone at those
    inputs (graph_ms), summed over the forward's 15 convs / 14 IN sites:
    quantize (the max-reduce and round(x / s)), patches (reflect-pad gather
    or zero insertion, and the patch matrix copy), _int_mm, dequantize, and
    the IN kernel, which is also set beside its bytes bound, its plain
    version and F.instance_norm at the same inputs."""
    import torch

    from fast_neural_style_transfer_tpu_torch.infer import quantized as q
    from fast_neural_style_transfer_tpu_torch.ops.cuda_norm import instance_norm_fwd_reference

    names = {"scale": "_shared_scales", "quantize": "_quantize_act", "pad": "_reflect_pad",
             "zero_insert": "_zero_insert", "patches": "_patches", "dequantize": "_dequantize",
             "in_kernel": "instance_norm"}
    caps = {k: capture_calls(q, n) for k, n in names.items()}
    mm = capture_calls(torch, "_int_mm")
    with torch.inference_mode():
        with contextlib.ExitStack() as stack:
            for cap in (*caps.values(), mm):
                stack.enter_context(cap)
            sty.raw_forward_u8(x_u8)
        real = {k: getattr(q, n) for k, n in names.items()}
        out = {}
        for k, cap in caps.items():
            out[k] = sum(graph_ms(lambda a=a, kw=kw, k=k: real[k](*a, **kw), reps=5)
                         for a, kw in cap.calls)
        out["int_mm"] = sum(graph_ms(lambda a=a: torch._int_mm(*a), reps=5)
                            for a, _ in mm.calls)
    out["quantize"] += out.pop("scale")
    out["patch_materialization"] = out.pop("pad") + out.pop("zero_insert") + out.pop("patches")
    out["sum"] = sum(out.values())
    # the IN sites beside their bound, the kernel's plain version and
    # F.instance_norm (+ F.relu), at the path's own inputs
    ins = caps["in_kernel"].calls
    out["in_kernel_bound_ms"] = sum(in_bound_ms(a[0].numel(), a[0].element_size())[0]
                                    for a, _ in ins)
    with torch.inference_mode():
        out["in_kernel_plain_ms"] = sum(
            graph_ms(lambda a=a, kw=kw: instance_norm_fwd_reference(*a, **kw), reps=5)
            for a, kw in ins)
        out["in_kernel_library_ms"] = sum(
            graph_ms(lambda a=a, kw=kw: _library_in(*a, relu=kw["relu"]), reps=5)
            for a, kw in ins)
    out["convs"] = len(mm.calls)
    out["in_sites"] = len(ins)
    return out


def phase_int8(seed: int) -> dict:
    """int8 inference (ROADMAP row 13) on the trained checkpoint at 256x256:
    Stylizer(precision="int8") on the card against the port's CPU int8 path
    at B=1 and B=8, with dynamic scales and with calibrated static ones (the
    same scales on both devices); the IN forward kernel runs at 14 sites a
    forward (counts set to 0 just before, read just after; the reflect-pad
    kernel none, since the int8 convs gather their own padded codes, and 13
    in the float calibration pass) and must match
    its plain version on the inputs the path gave it (``in_vs_plain``).
    Everything else on the path is exact or the same IEEE operation on both
    devices (int8 codes, ``_int_mm``'s int32 products, the dequantize, the
    residual adds, the u8 conversions), so the CPU path fed the card's IN
    outputs at the 14 sites runs each of the 15 convs on the card's input:
    the x it hands each IN site and its output must be the card's bit for
    bit. Free running, the two differ wherever the kernel's f32 roundings
    (within 1e-4 of the plain version's) flip an activation code, which the
    following instance norms can amplify: mean and max |du8| printed.
    The card's int8 must be as close to the f32
    output (SSIM, on the card) as the CPU's int8 is, within 0.02; no
    absolute limit (none was measured on trained weights). The
    begin_inference CLI with
    --precision int8, and fnst-serve --precision int8 in its own process
    answering 8 concurrent requests (SSIM >= 0.98 against the in-process
    int8 Stylizer at B=1: the server batches). Times: the u8 forward p50
    (CUDA events) of int8 (dynamic, static), f32 and bf16 at B=1 and B=8,
    the int8 forward's device time by stage, and a profile."""
    from unittest import mock

    import torch
    from PIL import Image

    from fast_neural_style_transfer_tpu_torch.cli import begin_inference
    from fast_neural_style_transfer_tpu_torch.infer import Stylizer
    from fast_neural_style_transfer_tpu_torch.infer import quantized as q
    from fast_neural_style_transfer_tpu_torch.models import NUM_IN_SITES
    from fast_neural_style_transfer_tpu_torch.ops.conv import reflect_pad_hw
    from fast_neural_style_transfer_tpu_torch.ops.cuda_norm import instance_norm_fwd
    from fast_neural_style_transfer_tpu_torch.utils.image_io import u8_to_network
    from fast_neural_style_transfer_tpu_torch.utils.ssim import ssim

    params = Stylizer.load_params(str(CHECKPOINT))
    card = Stylizer(params, precision="int8")
    cpu = Stylizer(params, precision="int8", device="cpu")
    f32 = Stylizer(params, precision="f32")
    bf16 = Stylizer(params, precision="bf16")
    dynamic = card.qparams
    sample = np.stack([smooth_image(256, 256, seed=seed + 400 + i) for i in range(8)])
    reset_launch_counts()
    static = q.calibrate(dynamic, params, u8_to_network(torch.from_numpy(sample).cuda()))
    result = {"checks": [], "launches": [], "pad_launches": [],
              "calibrate_pad_launches": reflect_pad_hw.launches}
    worst_in = 0.0
    t0 = time.perf_counter()
    for scales, qp in (("dynamic", dynamic), ("static", static)):
        card.qparams, cpu.qparams = qp, q.to_device(qp, "cpu")
        for n in INT8_BATCHES:
            imgs = np.stack([smooth_image(256, 256, seed=seed + 500 + i) for i in range(n)])
            reset_launch_counts()
            with capture_calls(q, "instance_norm") as cap:
                got = card.stylize_u8(imgs)
            torch.cuda.synchronize()
            launches = instance_norm_fwd.launches
            by_route = nonzero(instance_norm_fwd.launches_by_route)
            pad_launches = reflect_pad_hw.launches
            want = cpu.stylize_u8(imgs)
            # the kernel repeats bit for bit: these launches give the path's
            # IN outputs again (they are not the path's, read above). The CPU
            # path fed them runs each of the 15 convs on the card's input (the
            # residual adds included): the x it hands each IN site (a conv's
            # output) and its final output must be the card's bit for bit
            with torch.inference_mode():
                card_in = iter([q.instance_norm(*a, **kw).cpu() for a, kw in cap.calls])
            cpu_x = []

            def forced_in(x, *a, **kw):
                cpu_x.append(x)
                return next(card_in)

            with mock.patch.object(q, "instance_norm", forced_in):
                forced = cpu.stylize_u8(imgs)
            conv_bit_equal = [bool(torch.equal(x, a[0].cpu()))
                              for x, (a, _) in zip(cpu_x, cap.calls)]
            ref = f32.stylize_u8(imgs)
            if n == INT8_BATCHES[-1]:
                worst_in = max(worst_in, in_vs_plain(cap.calls, f"int8 {scales} B={n}"))
            du8 = lambda a, b: np.abs(a.astype(int) - b.astype(int))
            min_ssim = lambda xs, ys: float(ssim_card(xs, ys).min())
            if not result["checks"]:
                # ssim_card against utils/ssim.py, once
                ssim_helper_err = abs(float(ssim_card(got[:1], ref[:1])[0])
                                      - ssim(got[0] / 255.0, ref[0] / 255.0))
            check = {"scales": scales, "batch": n,
                     "bit_equal_given_card_in_outputs": bool(np.array_equal(forced, got)),
                     "in_sites_x_bit_equal": sum(conv_bit_equal),
                     "mean_abs_du8_vs_cpu": float(du8(got, want).mean()),
                     "max_abs_du8_vs_cpu": int(du8(got, want).max()),
                     "min_ssim_vs_cpu": min_ssim(got, want),
                     "min_ssim_vs_f32": min_ssim(got, ref),
                     "cpu_min_ssim_vs_f32": min_ssim(want, ref),
                     "ssim_card_vs_numpy_abs_err": ssim_helper_err,
                     "in_fwd_launches": launches, "launches_by_route": by_route,
                     "pad_launches": pad_launches}
            ok = bool(got.shape == imgs.shape and check["bit_equal_given_card_in_outputs"]
                      and len(cpu_x) == NUM_IN_SITES and all(conv_bit_equal)
                      and ssim_helper_err <= 1e-9
                      and check["min_ssim_vs_f32"] >= check["cpu_min_ssim_vs_f32"] - 0.02
                      and launches == NUM_IN_SITES and by_route == {SITE_ROUTE: NUM_IN_SITES}
                      and pad_launches == 0
                      and result["calibrate_pad_launches"] == STYLIZER_PADS)
            emit("int8_vs_cpu", seconds=time.perf_counter() - t0, size=[256, 256],
                 criterion="given the card's IN outputs, the 14 IN inputs and the output "
                           "bit-equal; as close to f32 as the CPU path (SSIM within 0.02); "
                           "14 IN launches", ok=ok, **check)
            if not ok:
                fail(f"int8 card vs CPU ({scales}, B={n})")
            result["checks"].append(check)
            result["launches"].append(launches)
            result["pad_launches"].append(pad_launches)
    card.qparams = dynamic

    # the inference CLI and the server
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "content.jpg")
        Image.fromarray(smooth_image(240, 320, seed=seed + 600)).save(src, quality=95)
        reset_launch_counts()
        begin_inference.main(["--model_path", str(CHECKPOINT), "--content_image", src,
                              "--output_dir", tmp, "--output_name", "out.png",
                              "--precision", "int8"])
        cli_launches = instance_norm_fwd.launches
        cli_size = Image.open(os.path.join(tmp, "out.png")).size
    img = smooth_image(256, 256, seed=seed + 610)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    served = serve_process(["--model", str(CHECKPOINT), "--precision", "int8"],
                           buf.getvalue(), "image/png", bursts=1, per_burst=8)
    replies = served.pop("replies")
    got = np.asarray(Image.open(io.BytesIO(replies[0][1])).convert("RGB"))
    score = ssim(got / 255.0, card.stylize_u8(img) / 255.0)
    ok = bool(cli_size == (320, 240) and cli_launches == NUM_IN_SITES
              and all(r[0] == 200 for r in replies) and len(replies) == 8
              and served["healthz"]["family"] == "flagship" and score >= 0.98)
    emit("int8_cli_and_serve", seconds=time.perf_counter() - t0,
         cli_output_size=list(cli_size), cli_in_launches=cli_launches,
         requests=len(replies), p50_ms=float(np.median([r[2] for r in replies])),
         ssim_vs_in_process=score, **served, ok=ok)
    if not ok:
        fail("int8 CLI / fnst-serve --precision int8")

    # times, one process: u8 -> u8 forward p50 between CUDA events
    times = {}
    for n in INT8_BATCHES:
        x = torch.from_numpy(np.stack([smooth_image(256, 256, seed=seed + 700 + i)
                                       for i in range(n)])).cuda()
        row = {}
        with torch.inference_mode():
            for name, sty, qp in (("int8_dynamic", card, dynamic), ("int8_static", card, static),
                                  ("f32", f32, None), ("bf16", bf16, None)):
                if qp is not None:
                    sty.qparams = qp
                row[name + "_ms"] = p50_ms(lambda: sty.raw_forward_u8(x))
            card.qparams = dynamic
            row["stages_ms"] = int8_stage_times(card, x)
            row["profile"] = profile_calls(lambda: card.raw_forward_u8(x), reps=5)
        times[n] = row
        emit("int8_times", seconds=time.perf_counter() - t0, batch=n, size=[256, 256], **row)
    result.update(times=times, in_max_abs_err=worst_in)
    return result


def phase_int8_sensitivity(seed: int) -> dict:
    """A recorded finding, on request only (``--phases int8_sensitivity``):
    how far the CPU int8 path moves when every IN output moves one ulp up,
    at phase_int8's images and batches, dynamic scales and static ones
    calibrated on the CPU. It runs only on the CPU; it says how much of the
    card-vs-CPU difference phase_int8 prints free running is the path's own
    sensitivity to f32 roundings."""
    from unittest import mock

    import torch

    from fast_neural_style_transfer_tpu_torch.infer import Stylizer
    from fast_neural_style_transfer_tpu_torch.infer import quantized as q
    from fast_neural_style_transfer_tpu_torch.utils.image_io import u8_to_network

    params = Stylizer.load_params(str(CHECKPOINT))
    cpu = Stylizer(params, precision="int8", device="cpu")
    dynamic = cpu.qparams
    sample = np.stack([smooth_image(256, 256, seed=seed + 400 + i) for i in range(8)])
    static = q.calibrate(dynamic, params, u8_to_network(torch.from_numpy(sample)))
    real_in = q.instance_norm
    up = torch.tensor(float("inf"))
    out = {}
    for scales, qp in (("dynamic", dynamic), ("static", static)):
        cpu.qparams = qp
        for n in INT8_BATCHES:
            imgs = np.stack([smooth_image(256, 256, seed=seed + 500 + i) for i in range(n)])
            want = cpu.stylize_u8(imgs)
            with mock.patch.object(q, "instance_norm", lambda *a, **kw: torch.nextafter(
                    real_in(*a, **kw), up)):
                nudged = cpu.stylize_u8(imgs)
            d = np.abs(nudged.astype(int) - want.astype(int))
            out[scales, n] = {"mean_abs_du8": float(d.mean()), "max_abs_du8": int(d.max())}
            emit("int8_sensitivity", scales=scales, batch=n, size=[256, 256], device="cpu",
                 perturbation="every IN output one ulp up", **out[scales, n])
    return out


def phase_train_parity_sensitivity(seed: int) -> dict:
    """A recorded finding, on request only (``--phases
    train_parity_sensitivity``): how far phase_train_parity's step moves
    its grad norm for reasons that are not a fault. On the CPU: the f32
    step against the same step with its IN statistics taken in f64 (stable
    and one-pass). On the card: the step under cuDNN's default algorithm
    choice three times, 8 GiB more of the card held each time, then twice
    with deterministic algorithms. And at the one-pass step's 14 IN inputs
    on the card: the largest relative error of inv = rsqrt(var + eps)
    against f64 statistics, of the kernel's and of the CPU plain
    version's."""
    from unittest import mock

    import torch

    from fast_neural_style_transfer_tpu_torch.models import NUM_IN_SITES
    from fast_neural_style_transfer_tpu_torch.models import transformer
    from fast_neural_style_transfer_tpu_torch.ops import cuda_norm
    from fast_neural_style_transfer_tpu_torch.ops.cuda_norm import instance_norm_fwd

    xs = []
    real_in = transformer.instance_norm

    def recorded(x, *a, **kw):
        xs.append(x.detach())
        return real_in(x, *a, **kw)

    with mock.patch.object(transformer, "instance_norm", recorded):
        _one_train_step("cuda", seed, norm_method="onepass")
    inv_err = {"card": 0.0, "cpu": 0.0}
    for x in xs[:NUM_IN_SITES]:
        xd = x.double().cpu()
        mean = xd.mean(dim=(2, 3))
        exact = torch.rsqrt((xd.square().mean(dim=(2, 3)) - mean.square()).clamp(min=0)
                            + 1e-5)
        for dev, xin in (("card", x), ("cpu", x.cpu())):
            ones = torch.ones(x.shape[1], device=xin.device)
            inv = instance_norm_fwd(xin, ones, torch.zeros_like(ones), onepass=True)[2]
            err = ((inv.double().cpu() - exact).abs() / exact).max().item()
            inv_err[dev] = max(inv_err[dev], err)
    emit("train_parity_sensitivity_in_stats", norm_method="onepass", sites=NUM_IN_SITES,
         max_inv_rel_err_vs_f64=inv_err)
    out = {"inv_rel_err_vs_f64": inv_err}
    f32_moments = cuda_norm._moments

    def f64_moments(xf, onepass):
        mean, var = f32_moments(xf.double(), onepass)
        return mean.float(), var.float()

    for method in ("auto", "onepass"):
        cpu = _one_train_step("cpu", seed, norm_method=method)[2]
        with mock.patch.object(cuda_norm, "_moments", f64_moments):
            cpu_f64 = _one_train_step("cpu", seed, norm_method=method)[2]
        held, default = [], []
        for _ in range(3):
            default.append(_one_train_step("cuda", seed, norm_method=method)[2])
            held.append(torch.empty(8 << 30, dtype=torch.uint8, device="cuda"))
        del held
        with deterministic_algorithms():
            det = [_one_train_step("cuda", seed, norm_method=method)[2] for _ in range(2)]
        rel = lambda g: abs(g - cpu) / cpu
        out[method] = dict(grad_norm_cpu=cpu, grad_norm_cpu_f64_stats=cpu_f64,
                           cpu_f64_stats_rel=rel(cpu_f64), grad_norm_card_default=default,
                           card_default_rel=[rel(g) for g in default],
                           grad_norm_card_deterministic=det,
                           card_deterministic_rel=[rel(g) for g in det])
        emit("train_parity_sensitivity", norm_method=method, size=[128, 128], batch=2,
             **out[method])
    return out


# -- row 15a: height-sharded inference, training and AdaIN --------------------

SPATIAL_RANKS = 2  # ranks that share the card (gloo) in the spatial phases
SPATIAL_SIZES = ((2160, 3840), (1001, 1500))  # 4K UHD (aligned); unaligned
SPATIAL_TRAIN_SIZE, SPATIAL_TRAIN_BATCH, SPATIAL_TRAIN_STEPS = 512, 2, 3
# one rank's shard slabs on the sharded paths with two ranks: (name, n, c,
# h, w, active rows, relu); the last three are the training path's
SHARD_SLABS = [
    ("4k_norm1", 1, 64, 540, 1920, 540, True),
    ("4k_norm2_res", 1, 256, 270, 960, 270, True),
    ("4k_norm4", 1, 32, 1080, 3840, 1080, True),
    ("1001x1500_norm1_rank1", 1, 64, 252, 750, 250, True),  # the extent mask
    ("adain_relu4_1_1001x1500", 1, 512, 63, 188, 63, False),
    ("train512_norm1", 2, 64, 128, 256, 128, True),
    ("train512_norm2_res", 2, 256, 64, 128, 64, True),
    ("train512_norm4", 2, 32, 256, 512, 256, True),
]
# the IN sites of one sharded stylizer forward per rank: (slab, sites) for
# the 4K forward and the 512^2 B=2 training step (in2's five sites are
# timed as norm2's, with ReLU)
SHARD_SITES = {"4k": [("4k_norm1", 2), ("4k_norm2_res", 11), ("4k_norm4", 1)],
               "train512": [("train512_norm1", 2), ("train512_norm2_res", 11),
                            ("train512_norm4", 1)]}


def nccl_note(phase: str) -> bool:
    """Whether this machine can run the phase again with NCCL, one rank a
    card; if not, say so (it does not count as a pass)."""
    import torch

    cards = torch.cuda.device_count()
    if cards >= SPATIAL_RANKS:
        return True
    emit(f"{phase}_nccl", ran=False, cards=cards,
         reason=f"NCCL needs a card per rank ({SPATIAL_RANKS} ranks, {cards} card): "
                "it refuses two ranks on one card; the phase ran on gloo only")
    return False


def free_card() -> None:
    """Hand this process's cached device memory back before ranks that
    share the card start."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def rank_counts(counts: list, fn: str = "instance_norm_fwd") -> list:
    """Each rank's nonzero launches by mode of ``fn``."""
    return [nonzero(c.get(fn, {}).get("launches_by_mode", {})) for c in counts]


def phase_sharded_in_vs_plain(seed: int) -> dict:
    """The sharded IN modes against their plain versions (the same formulas
    in PyTorch, run on the card on the same inputs) at the shard slabs of
    the sharded paths (SHARD_SLABS), f32 and bf16, each call twice for
    bit-for-bit repeats: the statistics-only route (on the route
    ``plan_fwd`` picks for the active rows), the sharded apply with (C,)
    and (N, C) affines (rows past the extent relu(beta)), and at the
    training slabs the backward's sums and apply with both affines.
    Tolerances: mean |d| <= 1e-5 + 1e-4|mean|, var relative 1e-4 (f32 sums
    of up to 4M elements in another order); y as the forward's (f32 1e-4 +
    1e-4|y|, bf16 1e-4 + 2^-7|y|); the sums 1e-5 of the sum of the terms'
    magnitudes; dx f32 1e-4 of max|dx| + 1e-4|dx|, bf16 1e-4 of max|dx| +
    2^-7|dx|."""
    import torch

    from fast_neural_style_transfer_tpu_torch.ops import cuda_norm as cn

    gen = torch.Generator(device="cuda").manual_seed(seed)
    worst = dict.fromkeys(("stats", "sharded_apply", "bwd_sums", "bwd_apply"), 0.0)
    for name, n, c, h, w, rows, relu in SHARD_SLABS:
        base = torch.randn((n, c, h, w), generator=gen, device="cuda") * 2 + 0.5
        gy = torch.randn((n, c, h, w), generator=gen, device="cuda")
        affines = {"channel": (torch.rand(c, generator=gen, device="cuda") + 0.5,
                               torch.randn(c, generator=gen, device="cuda")),
                   "sample": (torch.rand((n, c), generator=gen, device="cuda") + 0.5,
                              torch.randn((n, c), generator=gen, device="cuda"))}
        for dtype in (torch.float32, torch.bfloat16):
            x = base.to(dtype).contiguous(memory_format=torch.channels_last)
            g = gy.to(dtype).contiguous(memory_format=torch.channels_last)
            plan = cn.fwd_plan(x, rows=rows, sharded=True)
            with torch.inference_mode():
                m, v = cn.instance_norm_moments(x, rows)
                m2, v2 = cn.instance_norm_moments(x, rows)
                m_r, v_r = cn._moments(x[:, :, :rows].float(), False)
            rep = torch.equal(bits(m), bits(m2)) and torch.equal(bits(v), bits(v2))
            m_over = ((m - m_r).abs() / (1e-5 + 1e-4 * m_r.abs())).max().item()
            v_rel = ((v - v_r).abs() / v_r).max().item()
            worst["stats"] = max(worst["stats"], (m - m_r).abs().max().item(),
                                 (v - v_r).abs().max().item())
            ok = rep and m_over <= 1 and v_rel <= 1e-4
            emit("sharded_in_vs_plain", mode="stats", slab=name, shape=[n, c, h, w],
                 rows=rows, dtype=str(dtype).replace("torch.", ""), route=plan.route,
                 chunks_per_sample=plan.chunks, mean_err_over_tol=m_over,
                 var_max_rel_err=v_rel, bitwise_repeatable=rep, ok=ok)
            if not ok:
                fail(f"sharded IN statistics at {name} {dtype}")
            rtol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
            inv_r = torch.rsqrt(v_r + 1e-5)
            for kind, (gam, bet) in affines.items():
                with torch.inference_mode():
                    y, inv = cn.instance_norm_apply_global(x, gam, bet, m_r, v_r,
                                                           rows=rows, relu=relu)
                    y2, _ = cn.instance_norm_apply_global(x, gam, bet, m_r, v_r,
                                                          rows=rows, relu=relu)
                    y_r, _ = cn.instance_norm_apply_global_reference(
                        x, gam, bet, m_r, v_r, rows=rows, relu=relu)
                rep = torch.equal(bits(y), bits(y2))
                dy = (y.float() - y_r.float()).abs()
                over = (dy / (1e-4 + rtol * y_r.float().abs())).max().item()
                worst["sharded_apply"] = max(worst["sharded_apply"], dy.max().item())
                ok = rep and over <= 1
                emit("sharded_in_vs_plain", mode="sharded_apply", slab=name,
                     shape=[n, c, h, w], rows=rows, affine=kind, relu=relu,
                     dtype=str(dtype).replace("torch.", ""), y_max_abs_err=dy.max().item(),
                     y_err_over_tol=over, bitwise_repeatable=rep, ok=ok)
                if not ok:
                    fail(f"sharded IN apply at {name} {dtype} {kind}")
                del y, y2, y_r, dy
                if not name.startswith("train"):
                    continue
                args = (x, g, m_r, inv_r, gam, bet)
                with torch.inference_mode():
                    s = cn.instance_norm_bwd_sums(*args, relu=relu)
                    s2 = cn.instance_norm_bwd_sums(*args, relu=relu)
                    s_r = cn.instance_norm_bwd_sums_reference(*args, relu=relu)
                    xh, gf = cn._gated(*args, relu)
                    scale = (gf.abs().sum(dim=(2, 3)), (gf * xh).abs().sum(dim=(2, 3)))
                rep = all(torch.equal(bits(a), bits(b)) for a, b in zip(s, s2))
                s_over = max(((a - b).abs() / (1e-5 * sc + 1e-6)).max().item()
                             for a, b, sc in zip(s, s_r, scale))
                worst["bwd_sums"] = max(worst["bwd_sums"], *((a - b).abs().max().item()
                                                              for a, b in zip(s, s_r)))
                count = SPATIAL_RANKS * h * w  # the global pixels of the test
                with torch.inference_mode():
                    dx = cn.instance_norm_bwd_apply(*args, s_r[0], s_r[1], count, relu=relu)
                    dx2 = cn.instance_norm_bwd_apply(*args, s_r[0], s_r[1], count,
                                                     relu=relu)
                    dx_r = cn.instance_norm_bwd_apply_reference(*args, s_r[0], s_r[1],
                                                                count, relu=relu)
                rep = rep and torch.equal(bits(dx), bits(dx2))
                ddx = (dx.float() - dx_r.float()).abs()
                top = dx_r.float().abs().max().item()
                dx_over = (ddx / (1e-4 * top + rtol * dx_r.float().abs())).max().item()
                worst["bwd_apply"] = max(worst["bwd_apply"], ddx.max().item())
                ok = rep and s_over <= 1 and dx_over <= 1
                emit("sharded_in_vs_plain", mode="bwd", slab=name, shape=[n, c, h, w],
                     affine=kind, relu=relu, dtype=str(dtype).replace("torch.", ""),
                     sums_err_over_tol=s_over, dx_max_abs_err=ddx.max().item(),
                     dx_err_over_tol=dx_over, bitwise_repeatable=rep, ok=ok)
                if not ok:
                    fail(f"sharded IN backward at {name} {dtype} {kind}")
                del dx, dx2, dx_r, ddx, xh, gf
            del x, g
        del base, gy
        torch.cuda.empty_cache()
    emit("sharded_in_vs_plain_worst", **worst)
    return worst


def spatial_compare_rank(plan, params: dict, images: dict, precisions) -> dict:
    """One rank's sharded stylizer on the u8 images (the Stylizer's own u8
    path: ``u8_to_network``, the forward, ``network_to_u8``) ->
    {(name, precision): u8 output}, the seconds of each first call and the
    peak device bytes each call allocated above what was live before it."""
    import torch

    from fast_neural_style_transfer_tpu_torch.core.dtypes import canonical_compute_dtype
    from fast_neural_style_transfer_tpu_torch.infer.spatial import stylize_spatial
    from fast_neural_style_transfer_tpu_torch.train.step import exact_f32
    from fast_neural_style_transfer_tpu_torch.utils.image_io import (
        network_to_u8,
        u8_to_network,
    )

    net = _spatial_net(plan, params)
    out, seconds, peak = {}, {}, {}
    for name, img in images.items():
        for p in precisions:
            prec = canonical_compute_dtype(p)
            exact_f32(plan.device, prec)
            torch.cuda.synchronize()
            live = torch.cuda.memory_allocated(plan.device)
            torch.cuda.reset_peak_memory_stats(plan.device)
            t0 = time.perf_counter()
            x = u8_to_network(torch.from_numpy(img[None]).to(plan.device))
            y = stylize_spatial(net, x, plan, precision=prec)
            out[name, p] = network_to_u8(y.float())[0].cpu().numpy()
            seconds[name, p] = time.perf_counter() - t0
            peak[name, p] = torch.cuda.max_memory_allocated(plan.device) - live
            del x, y
    return {"u8": out if plan.space.index == 0 else None, "seconds": seconds,
            "peak_bytes": peak}


def _spatial_net(plan, params: dict):
    import torch

    from fast_neural_style_transfer_tpu_torch.models import TransformerNet

    net = TransformerNet()
    net.load_state_dict(params, strict=True)
    return net.eval().to(plan.device, memory_format=torch.channels_last)


def spatial_profile_rank(plan, params: dict, image, precisions) -> dict:
    """One rank's profile of three sharded stylizer calls of each precision
    on ``image`` (every rank calls alike: the calls exchange rows), and the
    exchanges alone, host clock per call (the backend's, not NCCL's where
    gloo runs): a k9 conv's halo at the 4K input (3 channels, 4 rows of
    3840) and at norm1's scale (64 channels, 4 rows of 1920), and one IN
    site's moments (3 x 256 float64)."""
    import torch

    from fast_neural_style_transfer_tpu_torch.core.dtypes import canonical_compute_dtype
    from fast_neural_style_transfer_tpu_torch.infer.spatial import stylize_spatial
    from fast_neural_style_transfer_tpu_torch.train.step import exact_f32
    from fast_neural_style_transfer_tpu_torch.utils.image_io import u8_to_network

    net = _spatial_net(plan, params)
    x = u8_to_network(torch.from_numpy(image[None]).to(plan.device))
    profiles = {}
    for p in precisions:
        prec = canonical_compute_dtype(p)
        exact_f32(plan.device, prec)
        profiles[p] = profile_calls(
            lambda: stylize_spatial(net, x, plan, precision=prec), reps=3)
    collective_ms = {}
    for key, shape, dtype in (("halo_3x4x3840", (1, 3, 4, 3840), torch.float32),
                              ("halo_64x4x1920", (1, 64, 4, 1920), torch.float32),
                              ("moments_3x256", (3, 1, 256), torch.float64)):
        t = torch.randn(shape, dtype=dtype, device=plan.device)
        op = (lambda: plan.space.shift(t, 1)) if key.startswith("halo") else (
            lambda: plan.space.gather(t))
        op()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            op()
        torch.cuda.synchronize()
        collective_ms[key] = (time.perf_counter() - t0) * 1e3 / 20
    return {"profiles": profiles, "collective_ms": collective_ms,
            "transport": plan.space.transport_for(x)}


def phase_spatial(seed: int) -> dict:
    """The height-sharded inference path (ROADMAP row 15a): the inference
    CLI with --spatial 2 on the trained checkpoint at 1001x1500 (unaligned,
    so the extent path runs), two ranks sharing the card over gloo; each
    rank's launch counts start at 0 in its own process and are read at its
    end (``parallel.launch.kernel_counts``): every IN site a statistics
    launch and a sharded-apply launch (14 + 14 a rank), no plain launch.
    Then the sharded stylizer against the unsharded Stylizer (reflect pad
    to a multiple of 4, as the sharded route: ``bucket_multiple=4``) on the
    card at 2160x3840 and 1001x1500: f32 max |du8| <= 1, bf16 SSIM >= 0.98
    against the unsharded bf16 Stylizer (and, reported, against f32); the
    CLI's image against the unsharded f32 Stylizer, max |du8| <= 1."""
    import torch
    from PIL import Image

    from fast_neural_style_transfer_tpu_torch.cli import begin_inference
    from fast_neural_style_transfer_tpu_torch.infer import Stylizer
    from fast_neural_style_transfer_tpu_torch.models import NUM_IN_SITES
    from fast_neural_style_transfer_tpu_torch.models.weights import load_checkpoint
    from fast_neural_style_transfer_tpu_torch.parallel import launch

    images = {f"{h}x{w}": smooth_image(h, w, seed=4000 + h) for h, w in SPATIAL_SIZES}
    result = {}
    with tempfile.TemporaryDirectory() as tmp:
        h, w = SPATIAL_SIZES[1]
        src = os.path.join(tmp, "content.png")
        Image.fromarray(images[f"{h}x{w}"]).save(src)
        free_card()
        reset_launch_counts()
        launch.kernel_counts = None
        t0 = time.perf_counter()
        begin_inference.main(["--model_path", str(CHECKPOINT), "--content_image", src,
                              "--output_dir", tmp, "--output_name", "spatial.png",
                              "--spatial", str(SPATIAL_RANKS)])
        seconds = time.perf_counter() - t0
        counts = launch.kernel_counts
        cli_u8 = np.asarray(Image.open(os.path.join(tmp, "spatial.png")).convert("RGB"))
    by_mode = rank_counts(counts)
    expected = {"stats": NUM_IN_SITES, "sharded_apply": NUM_IN_SITES}
    params = load_checkpoint(str(CHECKPOINT))
    want, unsharded_peak = {}, {}
    for p in ("f32", "bf16"):
        sty = Stylizer(params, precision=p, bucket_multiple=4, device="cuda")
        for name, img in images.items():
            torch.cuda.synchronize()
            live = torch.cuda.memory_allocated()  # what earlier phases left
            torch.cuda.reset_peak_memory_stats()
            want[name, p] = sty.stylize_u8(img)
            unsharded_peak[name, p] = torch.cuda.max_memory_allocated() - live
        del sty
    free_card()
    cli_du8 = _du8(cli_u8, want[f"{h}x{w}", "f32"])
    ok = (len(by_mode) == SPATIAL_RANKS and all(m == expected for m in by_mode)
          and cli_u8.shape == (h, w, 3) and cli_du8 <= 1)
    emit("spatial_cli", ok=ok, ranks=SPATIAL_RANKS, size=[h, w], precision="f32",
         seconds=seconds, launches_by_mode_per_rank=by_mode,
         expected_per_rank=expected, max_abs_du8_vs_unsharded_stylizer=cli_du8)
    if not ok:
        fail("spatial inference CLI")
    result["counts"] = counts

    def compare(backend):
        got = launch(spatial_compare_rank, SPATIAL_RANKS,
                     (params, images, ("f32", "bf16")), device="cuda", backend=backend)
        checks = {}
        for name in images:
            du8 = _du8(got[0]["u8"][name, "f32"], want[name, "f32"])
            pair = lambda a, b: float(ssim_card(a[None], b[None])[0])  # noqa: E731
            s_bf16 = pair(got[0]["u8"][name, "bf16"], want[name, "bf16"])
            s_f32 = pair(got[0]["u8"][name, "bf16"], want[name, "f32"])
            good = du8 <= 1 and s_bf16 >= 0.98
            checks[name] = good
            emit("spatial_vs_unsharded", backend=backend, size=name, ranks=SPATIAL_RANKS,
                 f32_max_abs_du8=du8, bf16_ssim_vs_unsharded_bf16=s_bf16,
                 bf16_ssim_vs_unsharded_f32=s_f32,
                 seconds={p: got[0]["seconds"][name, p] for p in ("f32", "bf16")},
                 criterion="f32 max|du8|<=1, bf16 SSIM>=0.98", ok=good)
        # the peak one call allocates above what was live before it, in MiB:
        # each rank's (each process also holds a CUDA context and its
        # weights, not counted) and the unsharded Stylizer's
        mib = lambda b: b / 2 ** 20  # noqa: E731
        for name in images:
            for p in ("f32", "bf16"):
                ranks_mib = [mib(r["peak_bytes"][name, p]) for r in got]
                emit("spatial_memory", backend=backend, size=name, precision=p,
                     rank_call_peak_mib=ranks_mib, ranks_sum_mib=sum(ranks_mib),
                     unsharded_call_peak_mib=mib(unsharded_peak[name, p]))
        if not all(checks.values()):
            fail(f"sharded stylizer against the unsharded Stylizer ({backend})")

    compare("gloo")
    if nccl_note("spatial"):
        compare("nccl")
    return result


def spatial_step_rank(plan, seed: int, size: int, batch: int) -> dict:
    """One f32 sharded step (no dropout, deterministic algorithms) from the
    seeded inputs of ``_one_train_step``, on this rank's data shard of the
    batch (all of it with a data degree of 1) -> loss, grad norm, the
    gradients the step hands Adam (summed over the ranks), params after,
    and the step's kernel counts (set to 0 just before it)."""
    from fast_neural_style_transfer_tpu_torch.parallel.mesh import kernel_counts
    from fast_neural_style_transfer_tpu_torch.train.spatial_step import (
        make_spatial_train_step,
    )
    from fast_neural_style_transfer_tpu_torch.train.state import create_train_state

    with deterministic_algorithms():
        net, vgg, u8, grams, _ = _train_inputs(str(plan.device), seed, size, batch)
        state = create_train_state(net)
        applied = []
        update = state.optimizer.update

        def spy(grads):  # the gradients the step applies, as it applies them
            applied.extend(g.detach().float().cpu().clone() for g in grads)
            return update(grads)

        state.optimizer.update = spy
        step, local = make_spatial_train_step(plan, dropout=False), rank_slice(u8, plan.data)
        reset_launch_counts()
        reset_conv_counts()
        m = step(state, vgg, local, grams)
        counts = kernel_counts()
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "step": state.step, "grads": applied, "backend": plan.backend, "counts": counts,
            "layout": [plan.world.index, plan.data.index, plan.space.index],
            "params": [p.detach().float().cpu().clone() for p in net.parameters()]}


def spatial_step_profile_rank(plan, seed: int, size: int, batch: int) -> dict:
    """One rank's profile of three sharded f32 steps after a first one
    (every rank alike)."""
    from fast_neural_style_transfer_tpu_torch.train.spatial_step import (
        make_spatial_train_step,
    )
    from fast_neural_style_transfer_tpu_torch.train.state import create_train_state

    net, vgg, u8, grams, _ = _train_inputs(str(plan.device), seed, size, batch)
    state = create_train_state(net)
    step = make_spatial_train_step(plan, dropout=False)
    step(state, vgg, u8, grams)
    return profile_calls(lambda: step(state, vgg, u8, grams), reps=3)


def unsharded_step_ms(seed: int, size: int, batch: int, reps: int = 3) -> float:
    """Host-clock p50 of the unsharded f32 step on the same inputs."""
    import torch

    from fast_neural_style_transfer_tpu_torch.train.state import create_train_state
    from fast_neural_style_transfer_tpu_torch.train.step import make_train_step

    net, vgg, u8, grams, _ = _train_inputs("cuda", seed, size, batch)
    state, step = create_train_state(net), make_train_step(dropout=False)
    step(state, vgg, u8, grams)
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, vgg, u8, grams)
        walls.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(walls))


def phase_spatial_train(seed: int) -> dict:
    """One f32 sharded training step (two ranks sharing the card, gloo) at
    512x512, B=2, the full-width stylizer and the seeded VGG, against the
    unsharded card step on the same inputs, both under deterministic
    algorithms: loss relative 1e-4, grad norm relative 1e-3 (the JAX
    package's metric tolerance), every gradient the step hands Adam (summed
    over the ranks) within 1e-3 of the largest gradient, as
    ``phase_train_parity`` holds them, gradients and params bit-equal across
    ranks. Params after the step are held within 2.5e-3, the JAX package's
    own ``tests/test_spatial_train.py`` bound; that check cannot fail after
    one step (Adam's first update moves an element by at most about lr =
    1e-3 whatever its gradient), so the gradients carry the check.
    Then the main path: the training CLI with --spatial 2 for
    SPATIAL_TRAIN_STEPS steps at 512x512, B=2 on synthetic JPEGs; each
    rank's counts read at its end: 14 statistics and 14 sharded-apply
    launches, 14 backward-sums and 14 backward-apply launches a step, no
    plain IN launch (the sharded VGG's convs are cuDNN's, as the JAX
    package's sharded convs are plain lax: no conv1_1 dx kernel)."""
    import torch
    from PIL import Image

    from fast_neural_style_transfer_tpu_torch.cli import begin_training
    from fast_neural_style_transfer_tpu_torch.models import NUM_IN_SITES
    from fast_neural_style_transfer_tpu_torch.parallel import launch

    size, batch = SPATIAL_TRAIN_SIZE, SPATIAL_TRAIN_BATCH

    def parity(backend):
        free_card()
        ranks = launch(spatial_step_rank, SPATIAL_RANKS, (seed, size, batch),
                       device="cuda", backend=backend)
        with deterministic_algorithms():
            flat = _one_train_step("cuda", seed, size=size, batch=batch)
        free_card()
        loss_rel = abs(ranks[0]["loss"] - flat[0]) / abs(flat[0])
        norm_rel = abs(ranks[0]["grad_norm"] - flat[2]) / flat[2]
        gmax = max(g.abs().max().item() for g in flat[1])
        errs = [(a - b).abs().max().item() for a, b in zip(ranks[0]["grads"], flat[1])]
        grad_err = max(errs) / gmax
        worst = int(np.argmax(errs))
        dp = max((a - b).abs().max().item() for a, b in zip(ranks[0]["params"], flat[4]))
        equal = all(torch.equal(a, b) for r in ranks[1:]
                    for key in ("grads", "params") for a, b in zip(r[key], ranks[0][key]))
        ok = (loss_rel <= 1e-4 and norm_rel <= 1e-3 and grad_err <= 1e-3
              and len(errs) == len(flat[1]) and dp <= 2.5e-3 and equal
              and all(r["step"] == 1 for r in ranks))
        emit("spatial_train_parity", backend=backend, ranks=SPATIAL_RANKS,
             size=[size, size], batch=batch, precision="f32",
             card_deterministic_algorithms=True, loss_sharded=ranks[0]["loss"],
             loss_unsharded=flat[0], loss_rel_err=loss_rel,
             grad_norm_sharded=ranks[0]["grad_norm"], grad_norm_unsharded=flat[2],
             grad_norm_rel_err=norm_rel, grad_max_abs_err_over_max_grad=grad_err,
             worst_grad_param=_param_names(1)[worst][0], max_grad=gmax,
             param_max_abs_err=dp, grads_and_params_bit_equal_across_ranks=equal,
             ok=ok)
        if not ok:
            fail(f"sharded train step parity ({backend})")

    parity("gloo")
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        os.makedirs(data)
        for i in range(8):
            Image.fromarray(smooth_image(size + 16 * (i % 3), size + 8 * (i % 2),
                                         seed=5000 + i)).save(
                os.path.join(data, f"{i:03d}.jpg"), quality=92)
        style = os.path.join(tmp, "style.jpg")
        Image.fromarray(smooth_image(size, size, seed=5999)).save(style, quality=95)
        out = os.path.join(tmp, "out")
        free_card()
        reset_launch_counts()
        launch.kernel_counts = None
        t0 = time.perf_counter()
        final = begin_training.main([
            "--dataset_dir", data, "--style_image", style, "--output_dir", out,
            "--total_steps", str(SPATIAL_TRAIN_STEPS), "--batch_size", str(batch),
            "--image_size", str(size), str(size), "--spatial", str(SPATIAL_RANKS),
            "--training_monitor_content_image", "", "--seed", str(seed),
            "--num_workers", "2"])
        seconds = time.perf_counter() - t0
        counts = launch.kernel_counts
        with open(os.path.join(out, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        wrote = os.path.exists(final)
    per_step = NUM_IN_SITES * SPATIAL_TRAIN_STEPS
    expected_fwd = {"stats": per_step, "sharded_apply": per_step}
    expected_bwd = {"bwd_sums": per_step, "bwd_apply": per_step}
    fwd, bwd = rank_counts(counts), rank_counts(counts, "instance_norm_bwd")
    finite = all(np.isfinite(r["loss"]) and r["skipped_nonfinite"] == 0 for r in records)
    ok = (wrote and finite and records and records[-1]["step"] == SPATIAL_TRAIN_STEPS
          and len(fwd) == SPATIAL_RANKS and all(m == expected_fwd for m in fwd)
          and all(m == expected_bwd for m in bwd))
    emit("spatial_training_cli", ok=ok, ranks=SPATIAL_RANKS, steps=SPATIAL_TRAIN_STEPS,
         batch=batch, size=[size, size], precision="f32", seconds=seconds,
         metrics=records, fwd_launches_by_mode_per_rank=fwd,
         bwd_launches_by_mode_per_rank=bwd, expected_fwd=expected_fwd,
         expected_bwd=expected_bwd)
    if not ok:
        fail("spatial training CLI")
    if nccl_note("spatial_train"):
        parity("nccl")
    return {"counts": counts}


def phase_spatial_adain(seed: int, decoder=None) -> dict:
    """Height-sharded AdaIN (ROADMAP row 15a): ``adain stylize --spatial 2``
    with the ``adain`` phase's decoder (or the seeded one) on a 1001x1500
    content and two blended styles, against the unsharded stylize CLI on
    the card (the same reflect pad to a multiple of 8): f32 max |du8| <= 1.
    Each rank's counts: the AdaIN transform at relu4_1 is one statistics
    launch and one sharded-apply launch ((C,) affine: the blended style's
    sigma, mu)."""
    from PIL import Image

    from fast_neural_style_transfer_tpu_torch.cli import adain as adain_cli
    from fast_neural_style_transfer_tpu_torch.models.adain import save_decoder_npz
    from fast_neural_style_transfer_tpu_torch.parallel import launch

    h, w = SPATIAL_SIZES[1]
    with tempfile.TemporaryDirectory() as tmp:
        if decoder is None:
            decoder = seeded_adain_decoder(tmp, seed)
        else:
            save_decoder_npz(decoder, os.path.join(tmp, "decoder.npz"))
            decoder = os.path.join(tmp, "decoder.npz")
        content = os.path.join(tmp, "content.png")
        Image.fromarray(smooth_image(h, w, seed=4100)).save(content)
        styles = []
        for i in range(2):
            styles.append(os.path.join(tmp, f"style{i}.png"))
            Image.fromarray(smooth_image(256, 320, seed=4200 + i)).save(styles[-1])
        base = ["stylize", "--decoder", decoder, "--content_image", content,
                "--style_image", *styles, "--style_blend", "0.3", "0.7", "--alpha", "0.9"]
        free_card()
        reset_launch_counts()
        launch.kernel_counts = None
        t0 = time.perf_counter()
        adain_cli.main(base + ["--output", os.path.join(tmp, "s.png"),
                               "--spatial", str(SPATIAL_RANKS)])
        seconds = time.perf_counter() - t0
        counts = launch.kernel_counts
        adain_cli.main(base + ["--output", os.path.join(tmp, "u.png")])
        got, want = (np.asarray(Image.open(os.path.join(tmp, f)).convert("RGB"))
                     for f in ("s.png", "u.png"))
        if nccl_note("spatial_adain"):  # the CLI's rule picks NCCL, a card a rank
            adain_cli.main(base + ["--output", os.path.join(tmp, "n.png"),
                                   "--spatial", str(SPATIAL_RANKS)])
            n_du8 = _du8(np.asarray(Image.open(os.path.join(tmp, "n.png")).convert("RGB")),
                         want)
            emit("spatial_adain_nccl", ran=True, max_abs_du8_vs_unsharded=n_du8,
                 ok=n_du8 <= 1)
            if n_du8 > 1:
                fail("spatial AdaIN over NCCL")
    by_mode = rank_counts(counts)
    du8 = _du8(got, want)
    ok = (got.shape == want.shape == (h, w, 3) and du8 <= 1
          and by_mode == [{"stats": 1, "sharded_apply": 1}] * SPATIAL_RANKS)
    emit("spatial_adain_cli", ok=ok, ranks=SPATIAL_RANKS, size=[h, w], precision="f32",
         seconds=seconds, max_abs_du8_vs_unsharded=du8, output_std=float(got.std()),
         launches_by_mode_per_rank=by_mode, criterion="max|du8|<=1")
    if not ok:
        fail("spatial AdaIN against the unsharded AdaIN CLI")
    return {"counts": counts}


def phase_spatial_profile(seed: int) -> None:
    """Recorded finding, run on request only (not under ``all``): where the
    sharded paths' time goes with two ranks sharing the card over gloo. A
    profile of three sharded 4K stylizer calls a precision on each rank,
    beside the unsharded Stylizer's host-clock p50 of three calls; the
    exchanges alone (``spatial_profile_rank``); a profile of three sharded
    f32 steps at 512x512, B=2, beside the unsharded step's p50."""
    import torch

    from fast_neural_style_transfer_tpu_torch.infer import Stylizer
    from fast_neural_style_transfer_tpu_torch.models.weights import load_checkpoint
    from fast_neural_style_transfer_tpu_torch.parallel import launch

    h, w = SPATIAL_SIZES[0]
    name, image = f"{h}x{w}", smooth_image(h, w, seed=4000 + h)
    params = load_checkpoint(str(CHECKPOINT))
    unsharded_ms = {}
    for p in ("f32", "bf16"):
        sty = Stylizer(params, precision=p, bucket_multiple=4, device="cuda")
        sty.stylize_u8(image)
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sty.stylize_u8(image)
            walls.append((time.perf_counter() - t0) * 1e3)
        unsharded_ms[p] = float(np.median(walls))
        del sty
    free_card()
    got = launch(spatial_profile_rank, SPATIAL_RANKS, (params, image, ("f32", "bf16")),
                 device="cuda", backend="gloo")
    emit("spatial_collectives", backend="gloo", transport=got[0]["transport"],
         ranks=SPATIAL_RANKS, ms_per_call=[r["collective_ms"] for r in got])
    for p, prof in got[0]["profiles"].items():
        # one rank of two; the wall includes the exchanges and host work
        emit("spatial_profile", backend="gloo", size=name, precision=p, rank=0,
             unsharded_stylizer_wall_ms=unsharded_ms[p],
             rank1_wall_ms_per_call=got[1]["profiles"][p]["wall_ms_per_call"], **prof)
    size, batch = SPATIAL_TRAIN_SIZE, SPATIAL_TRAIN_BATCH
    step_ms = unsharded_step_ms(seed, size, batch)
    free_card()
    ranks = launch(spatial_step_profile_rank, SPATIAL_RANKS, (seed, size, batch),
                   device="cuda", backend="gloo")
    emit("spatial_train_profile", backend="gloo", rank=0, size=[size, size],
         batch=batch, precision="f32", unsharded_step_wall_ms=step_ms,
         rank1_wall_ms_per_call=ranks[1]["wall_ms_per_call"], **ranks[0])


def sharded_in_times(seed: int) -> dict:
    """Per-shard device times (CUDA-graph replay, one process) of the
    sharded IN modes, f32 and bf16, summed over the IN sites of one rank's
    share of a 2160x3840 forward (the forward's two modes) and of a 512x512
    B=2 training step (the backward's two passes), two ranks; beside each,
    its plain version, its bound (bytes: the active slab read once for the
    statistics; read once and written once for the apply; x and g read for
    the sums; x and g read and dx written for the apply) and the library
    call: ``torch.var_mean`` for the statistics,
    ``F.instance_norm(use_input_stats=False)`` for the apply, autograd of
    ``F.instance_norm`` less its forward for the backward."""
    import torch
    import torch.nn.functional as F

    from fast_neural_style_transfer_tpu_torch.ops import cuda_norm as cn

    slabs = {s[0]: s for s in SHARD_SLABS}
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).replace("torch.", "")
        tot = {}
        for path, modes in (("4k", ("stats", "sharded_apply")),
                            ("train512", ("bwd_sums", "bwd_apply"))):
            for name, sites in SHARD_SITES[path]:
                _, n, c, h, w, rows, relu = slabs[name]
                x = (torch.randn((n, c, h, w), generator=gen, device="cuda") * 2 + 0.5
                     ).to(dtype).contiguous(memory_format=torch.channels_last)
                g = torch.randn_like(x).contiguous(memory_format=torch.channels_last)
                gam = torch.rand(c, generator=gen, device="cuda") + 0.5
                bet = torch.randn(c, generator=gen, device="cuda")
                mean, var = cn._moments(x.float(), False)
                inv = torch.rsqrt(var + 1e-5)
                sums = cn.instance_norm_bwd_sums_reference(x, g, mean, inv, gam, bet,
                                                           relu=relu)
                count = SPATIAL_RANKS * h * w
                numel, item = x.numel(), x.element_size()
                reps = 3 if numel * item > 2e8 else 10
                fns = {
                    "stats": (lambda: cn.instance_norm_moments(x),
                              lambda: cn._moments(x.float(), False),
                              lambda: torch.var_mean(x, dim=(2, 3), unbiased=False),
                              numel * item, 3 * numel),
                    "sharded_apply": (
                        lambda: cn.instance_norm_apply_global(x, gam, bet, mean, var,
                                                              relu=relu),
                        lambda: cn.instance_norm_apply_global_reference(
                            x, gam, bet, mean, var, relu=relu),
                        lambda: F.instance_norm(x, running_mean=mean[0].to(dtype),
                                                running_var=var[0].to(dtype),
                                                weight=gam.to(dtype), bias=bet.to(dtype),
                                                use_input_stats=False),
                        2 * numel * item, 3 * numel),
                    "bwd_sums": (
                        lambda: cn.instance_norm_bwd_sums(x, g, mean, inv, gam, bet,
                                                          relu=relu),
                        lambda: cn.instance_norm_bwd_sums_reference(
                            x, g, mean, inv, gam, bet, relu=relu),
                        None, 2 * numel * item, 6 * numel),
                    "bwd_apply": (
                        lambda: cn.instance_norm_bwd_apply(x, g, mean, inv, gam, bet,
                                                           sums[0], sums[1], count,
                                                           relu=relu),
                        lambda: cn.instance_norm_bwd_apply_reference(
                            x, g, mean, inv, gam, bet, sums[0], sums[1], count, relu=relu),
                        None, 3 * numel * item, 8 * numel),
                }
                xl = x.detach().clone().requires_grad_(True)
                wl = gam.to(dtype).requires_grad_(True)
                bl = bet.to(dtype).requires_grad_(True)

                def lib_fwd():
                    y = F.instance_norm(xl, weight=wl, bias=bl)
                    return F.relu(y) if relu else y

                def lib_bwd():
                    y = lib_fwd()
                    torch.autograd.grad(y, (xl, wl, bl), g)

                for mode in modes:
                    kern, plain, lib, nbytes, flops = fns[mode]
                    with torch.inference_mode():
                        k_ms = graph_ms(kern, reps)
                        p_ms = graph_ms(plain, reps)
                        lib_ms = graph_ms(lib, reps) if lib else None
                    if mode == "bwd_sums":  # the library's whole backward
                        lib_ms = graph_ms(lib_bwd, reps) - graph_ms(lib_fwd, reps)
                    b_ms, b_by = bound(nbytes, flops, dt)
                    t = tot.setdefault(mode, {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                                              "library_ms": 0.0, "bound_by": b_by})
                    t["ms"] += sites * k_ms
                    t["plain_ms"] += sites * p_ms
                    t["bound_ms"] += sites * b_ms
                    if lib_ms is not None:
                        t["library_ms"] += sites * lib_ms
                    emit("sharded_in_times_site", dtype=dt, mode=mode, slab=name,
                         shape=[n, c, h, w], sites=sites, ms=k_ms, plain_ms=p_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
                del x, g, xl, fns
                torch.cuda.empty_cache()
        # the library has one backward: its time stands under bwd_sums, for
        # the two passes together
        tot["bwd_apply"]["library_ms"] = None
        out[dt] = tot
        emit("sharded_in_times", dtype=dt, ranks=SPATIAL_RANKS,
             per="one rank's sites: a 2160x3840 forward (stats, sharded_apply); "
                 "a 512x512 B=2 training step (bwd_sums, bwd_apply)", **tot)
    return out



DP_SIZE, DP_BATCH, DP_LOOP_STEPS = 256, 20, 3  # the stylizer's data-parallel step
DP_RANKS = 2  # data ranks sharing the card over gloo (data 2 x space 1)
DP_SERVE_BATCH = 8


def reset_conv_counts() -> None:
    """Set conv1_1 dx's launch counts, in all and by route, to 0."""
    from fast_neural_style_transfer_tpu_torch.ops.cuda_conv import conv2d_same_dx

    conv2d_same_dx.launches = 0
    conv2d_same_dx.launches_by_route = dict.fromkeys(conv2d_same_dx.launches_by_route, 0)


def rank_slice(t, data):
    """This rank's contiguous slice of a global batch on the data axis."""
    k = t.shape[0] // data.size
    return t[data.index * k:(data.index + 1) * k]


def _write_jpegs(d: str, n: int, size: int, seed: int) -> str:
    from PIL import Image

    os.makedirs(d)
    for i in range(n):
        Image.fromarray(smooth_image(size + 16 * (i % 3), size + 8 * (i % 2),
                                     seed=seed + i)).save(
            os.path.join(d, f"{i:03d}.jpg"), quality=92)
    return d


def dp_rank(plan, seed: int, data_dir: str, style: str, out: str) -> dict:
    """One rank of the data_parallel phase. On its slice of the global
    batch: one f32 stylizer step (256x256, B=20) and one AdaIN step
    (256x256, B=8) from ``_one_train_step``'s and ``_one_adain_step``'s
    seeded inputs under deterministic algorithms -> the global metrics, the
    gradients Adam was handed (summed over the ranks; the AdaIN step's
    averaged), params after; the step's host-clock walls and the flat
    gradient all_reduce's. Then the main path: the training loop
    (``train_style_transfer(cfg, plan)``) for DP_LOOP_STEPS steps at B=20,
    this rank's kernel counts set to 0 just before and read just after."""
    import torch

    from fast_neural_style_transfer_tpu_torch.core.dtypes import Precision
    from fast_neural_style_transfer_tpu_torch.models.adain import make_decoder
    from fast_neural_style_transfer_tpu_torch.models.vgg_weights import make_vgg, random_params
    from fast_neural_style_transfer_tpu_torch.parallel.mesh import kernel_counts
    from fast_neural_style_transfer_tpu_torch.train.adain import (
        create_adain_train_state,
        make_adain_train_step,
    )
    from fast_neural_style_transfer_tpu_torch.train.loop import TrainConfig, train_style_transfer
    from fast_neural_style_transfer_tpu_torch.train.state import create_train_state
    from fast_neural_style_transfer_tpu_torch.train.step import exact_f32, make_train_step

    d, dev = plan.data, plan.device
    cpu = lambda ts: [t.detach().float().cpu().clone() for t in ts]  # noqa: E731
    res = {"layout": [plan.world.index, d.index, plan.space.index], "backend": plan.backend}
    with deterministic_algorithms():
        net, vgg, u8, grams, _ = _train_inputs(str(dev), seed, DP_SIZE, DP_BATCH)
        state = create_train_state(net)
        applied, update = [], state.optimizer.update
        state.optimizer.update = lambda g: applied.extend(cpu(g)) or update(g)
        step = make_train_step(dropout=False, data=d)
        local = rank_slice(u8, d)
        m = step(state, vgg, local, grams)
        state.optimizer.update = update
    res["step"] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                   "step": state.step, "grads": applied, "params": cpu(net.parameters())}
    walls = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, vgg, local, grams)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    flat = torch.cat([p.detach().reshape(-1).clone() for p in net.parameters()])
    reduce_ms = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d.all_reduce_(flat)
        torch.cuda.synchronize()
        reduce_ms.append((time.perf_counter() - t0) * 1e3)
    res["step_ms"], res["grad_all_reduce_ms"] = walls[1:], reduce_ms[1:]
    res["grad_elements"] = int(flat.numel())
    del net, vgg, u8, state, step, flat
    with deterministic_algorithms():
        exact_f32(dev, Precision.f32())
        torch.manual_seed(seed)
        dec = make_decoder(None, dev)
        avgg = make_vgg(random_params(seed), dev)
        imgs = lambda s0: torch.from_numpy(np.stack(  # noqa: E731
            [smooth_image(DP_SIZE, DP_SIZE, seed=s0 + i) for i in range(ADAIN_BATCH)])).to(dev)
        ast_ = create_adain_train_state(dec)
        reset_launch_counts()
        reset_conv_counts()
        handed, opt_step = [], ast_.optimizer.step
        ast_.optimizer.step = lambda: handed.extend(cpu(p.grad for p in dec.parameters())) \
            or opt_step()
        am = make_adain_train_step(lr_decay=5e-5, data=d)(
            ast_, avgg, rank_slice(imgs(30), d), rank_slice(imgs(60), d))
    res["adain"] = {"loss": float(am["loss"]), "grad_norm": float(am["grad_norm"]),
                    "step": ast_.step, "grads": handed, "params": cpu(dec.parameters())}
    res["adain_counts"] = kernel_counts()
    del dec, avgg, ast_
    torch.cuda.empty_cache()
    cfg = TrainConfig(style_image=style, dataset_dir=data_dir, output_dir=out,
                      total_steps=DP_LOOP_STEPS, batch_size=DP_BATCH,
                      image_size=(DP_SIZE, DP_SIZE), log_every=1, checkpoint_every=10 ** 6,
                      num_workers=2, seed=seed, device=str(dev))
    reset_launch_counts()
    reset_conv_counts()
    res["final"] = train_style_transfer(cfg, plan)
    res["counts"] = kernel_counts()
    return res


def _step_parity(name: str, ranks: list, flat: tuple, key: str, **fields) -> dict:
    """``phase_train_parity``'s bounds for a data-parallel step against the
    one-process step on the same global batch: loss and grad norm 1e-4
    relative, every gradient handed to the optimizer within 1e-3 of the
    largest, gradients and params bit-equal across ranks."""
    import torch

    got = ranks[0][key]
    loss_rel = abs(got["loss"] - flat[0]) / abs(flat[0])
    norm_rel = abs(got["grad_norm"] - flat[2]) / flat[2]
    gmax = max(g.abs().max().item() for g in flat[1])
    errs = [(a - b).abs().max().item() for a, b in zip(got["grads"], flat[1])]
    grad_err = max(errs) / gmax
    equal = all(torch.equal(a, b) for r in ranks[1:] for k in ("grads", "params")
                for a, b in zip(r[key][k], got[k]))
    ok = (loss_rel <= 1e-4 and norm_rel <= 1e-4 and grad_err <= 1e-3
          and len(errs) == len(flat[1]) and equal and all(r[key]["step"] == 1 for r in ranks))
    emit(name, ranks=len(ranks), backend=ranks[0]["backend"], precision="f32",
         card_deterministic_algorithms=True, loss_data_parallel=got["loss"],
         loss_one_process=flat[0], loss_rel_err=loss_rel,
         grad_norm_data_parallel=got["grad_norm"], grad_norm_one_process=flat[2],
         grad_norm_rel_err=norm_rel, grad_max_abs_err_over_max_grad=grad_err, max_grad=gmax,
         grads_and_params_bit_equal_across_ranks=equal, ok=ok, **fields)
    if not ok:
        fail(f"{name}: data-parallel step against the one-process step")
    return {"loss_rel_err": loss_rel, "grad_norm_rel_err": norm_rel, "grad_err": grad_err}


def phase_data_parallel(seed: int) -> dict:
    """Data parallelism (ROADMAP row 15b): one launch of DP_RANKS ranks (data
    2 x space 1; on one card they share it over gloo), every check inside
    those ranks (``dp_rank``): the stylizer step at 256x256, global B=20 (10
    a rank), and the AdaIN step at B=8 (4 a rank) against the one-process
    step on the same global batch (``_step_parity``); then the main path,
    the training loop for DP_LOOP_STEPS steps: each rank's counts, 14 IN
    forward + 14 IN backward (all one-launch, mode "plain") + 1 conv1_1 dx
    (tap-packed) a step; rank 0 alone writes metrics and the final params.
    Also the data-parallel step's host-clock p50 and the flat gradient
    all_reduce's beside the one-process step's."""
    from fast_neural_style_transfer_tpu_torch.models import NUM_IN_SITES
    from fast_neural_style_transfer_tpu_torch.parallel import launch

    with tempfile.TemporaryDirectory() as tmp:
        data = _write_jpegs(os.path.join(tmp, "data"), 24, DP_SIZE, 8000)
        style = os.path.join(tmp, "style.jpg")
        from PIL import Image

        Image.fromarray(smooth_image(DP_SIZE, DP_SIZE, seed=8999)).save(style, quality=95)
        out = os.path.join(tmp, "out")
        free_card()
        t0 = time.perf_counter()
        ranks = launch(dp_rank, DP_RANKS, (seed, data, style, out), spatial=1, device="cuda")
        launch_s = time.perf_counter() - t0
        with open(os.path.join(out, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        wrote = os.path.exists(ranks[0]["final"])
    with deterministic_algorithms():
        flat = _one_train_step("cuda", seed, size=DP_SIZE, batch=DP_BATCH)
        aflat = _one_adain_step("cuda", seed, size=DP_SIZE, batch=ADAIN_BATCH)
    one_ms = unsharded_step_ms(seed, DP_SIZE, DP_BATCH)
    free_card()
    _step_parity("data_parallel_step", ranks, flat, "step", size=[DP_SIZE, DP_SIZE],
                 batch=DP_BATCH)
    _step_parity("data_parallel_adain_step", ranks, aflat, "adain", size=[DP_SIZE, DP_SIZE],
                 batch=ADAIN_BATCH)
    per_step = NUM_IN_SITES * DP_LOOP_STEPS
    counts = [r["counts"] for r in ranks]
    fwd, bwd = rank_counts(counts), rank_counts(counts, "instance_norm_bwd")
    routes = [(c["instance_norm_fwd"]["launches_by_route"],
               c["instance_norm_bwd"]["launches_by_route"],
               c["conv2d_same_dx"]["launches_by_route"]) for c in counts]
    finite = all(np.isfinite(r["loss"]) and r["skipped_nonfinite"] == 0 for r in records)
    ok = (wrote and finite and [r["step"] for r in records] == list(range(1, DP_LOOP_STEPS + 1))
          and all(f == {"plain": per_step} for f in fwd)
          and all(b == {"plain": per_step} for b in bwd)
          and all(nonzero(rf) == {"one_launch": per_step} == nonzero(rb)
                  and nonzero(rc) == {"tap_packed": DP_LOOP_STEPS} for rf, rb, rc in routes)
          and [r["layout"] for r in ranks] == [[0, 0, 0], [1, 1, 0]])
    p50 = lambda v: float(np.median(v))  # noqa: E731
    emit("data_parallel_training", ok=ok, ranks=DP_RANKS, backend=ranks[0]["backend"],
         layout=[r["layout"] for r in ranks], steps=DP_LOOP_STEPS, batch=DP_BATCH,
         per_rank_batch=DP_BATCH // DP_RANKS, size=[DP_SIZE, DP_SIZE], precision="f32",
         metrics=records, fwd_launches_by_mode_per_rank=fwd,
         bwd_launches_by_mode_per_rank=bwd,
         launches_by_route_per_rank=[{"instance_norm_fwd": nonzero(a),
                                      "instance_norm_bwd": nonzero(b),
                                      "conv2d_same_dx": nonzero(c)} for a, b, c in routes],
         step_ms_p50_per_rank=[p50(r["step_ms"]) for r in ranks],
         one_process_step_ms_p50=one_ms,
         grad_all_reduce_ms_p50_per_rank=[p50(r["grad_all_reduce_ms"]) for r in ranks],
         grad_elements=ranks[0]["grad_elements"],
         grad_bytes=4 * ranks[0]["grad_elements"], launch_seconds=launch_s)
    if not ok:
        fail("data-parallel training (counts, metrics or the final params)")
    adain_counts = [r["adain_counts"] for r in ranks]
    a_ok = all(c["instance_norm_fwd"]["launches"] == 1 and nonzero(
        c["conv2d_same_dx"]["launches_by_route"]) == {"tap_packed": 1} for c in adain_counts)
    emit("data_parallel_adain_counts", ok=a_ok,
         in_fwd_per_rank=[c["instance_norm_fwd"]["launches"] for c in adain_counts],
         conv_dx_by_route_per_rank=[nonzero(c["conv2d_same_dx"]["launches_by_route"])
                                    for c in adain_counts])
    if not a_ok:
        fail("data-parallel AdaIN step: launch counts")
    return {"counts": counts, "adain_counts": adain_counts}


def phase_data_space(seed: int) -> dict:
    """The 2-D mesh: one launch of 4 ranks, data 2 x space 2 (sharing the
    card over gloo), the sharded step at 512x512, B=2 (a sample a data
    shard, its rows over two ranks) against the unsharded card step on the
    same inputs, with ``phase_spatial_train``'s bounds (loss 1e-4 relative,
    grad norm 1e-3, every gradient within 1e-3 of the largest, params 2.5e-3,
    bit-equal across ranks); each rank's counts, set to 0 just before its
    step and read just after: 14 statistics + 14
    sharded-apply + 14 backward-sums + 14 backward-apply launches."""
    import torch

    from fast_neural_style_transfer_tpu_torch.models import NUM_IN_SITES
    from fast_neural_style_transfer_tpu_torch.parallel import launch

    size, batch = SPATIAL_TRAIN_SIZE, SPATIAL_TRAIN_BATCH
    free_card()
    t0 = time.perf_counter()
    ranks = launch(spatial_step_rank, 4, (seed, size, batch), spatial=2, device="cuda")
    launch_s = time.perf_counter() - t0
    counts = [r["counts"] for r in ranks]
    with deterministic_algorithms():
        flat = _one_train_step("cuda", seed, size=size, batch=batch)
    free_card()
    loss_rel = abs(ranks[0]["loss"] - flat[0]) / abs(flat[0])
    norm_rel = abs(ranks[0]["grad_norm"] - flat[2]) / flat[2]
    gmax = max(g.abs().max().item() for g in flat[1])
    grad_err = max((a - b).abs().max().item() for a, b in zip(ranks[0]["grads"], flat[1])) / gmax
    dp = max((a - b).abs().max().item() for a, b in zip(ranks[0]["params"], flat[4]))
    equal = all(torch.equal(a, b) for r in ranks[1:]
                for key in ("grads", "params") for a, b in zip(r[key], ranks[0][key]))
    fwd, bwd = rank_counts(counts), rank_counts(counts, "instance_norm_bwd")
    ok = (loss_rel <= 1e-4 and norm_rel <= 1e-3 and grad_err <= 1e-3 and dp <= 2.5e-3
          and equal and all(r["step"] == 1 for r in ranks)
          and [r["layout"] for r in ranks] == [[0, 0, 0], [1, 0, 1], [2, 1, 0], [3, 1, 1]]
          and all(f == {"stats": NUM_IN_SITES, "sharded_apply": NUM_IN_SITES} for f in fwd)
          and all(b == {"bwd_sums": NUM_IN_SITES, "bwd_apply": NUM_IN_SITES} for b in bwd))
    emit("data_space_step", ok=ok, ranks=4, mesh={"data": 2, "space": 2},
         backend=ranks[0]["backend"], layout=[r["layout"] for r in ranks],
         size=[size, size], batch=batch, precision="f32", card_deterministic_algorithms=True,
         loss_sharded=ranks[0]["loss"], loss_unsharded=flat[0], loss_rel_err=loss_rel,
         grad_norm_rel_err=norm_rel, grad_max_abs_err_over_max_grad=grad_err,
         param_max_abs_err=dp, grads_and_params_bit_equal_across_ranks=equal,
         fwd_launches_by_mode_per_rank=fwd, bwd_launches_by_mode_per_rank=bwd,
         launch_seconds=launch_s)
    if not ok:
        fail("data x space training step")
    return {"counts": counts}


@contextlib.contextmanager
def record_int8_scales(record: list):
    """Within the block, each conv of every int8 forward appends (its name,
    the scale its chunks were quantized with, the dynamic scale of the
    chunks' inputs laid end to end as one tensor, the first chunk's own
    dynamic scale); a forward visits its convs in ``_CONV_ORDER``."""
    import torch

    from fast_neural_style_transfer_tpu_torch.infer import quantized as q

    real = q._shared_scales

    def spy(ps, vs):
        scales = real(ps, vs)
        whole = q._quantize_act(torch.cat([v.to(vs[0].device) for v in vs]))[1]
        name = q._CONV_ORDER[len(record) % len(q._CONV_ORDER)]
        record.append((name, scales[0], whole, q._quantize_act(vs[0])[1]))
        return scales

    q._shared_scales = spy
    try:
        yield
    finally:
        q._shared_scales = real


def in_plan_follows_n(seed: int, n: int) -> list:
    """At each 256x256 IN site, f32: the IN forward kernel on n samples and
    on their first n // 2 alone, whether those samples' outputs are
    bit-equal and the kernel's chunks a sample (``fwd_plan``) at each N."""
    import torch

    from fast_neural_style_transfer_tpu_torch.ops.cuda_norm import fwd_plan
    from fast_neural_style_transfer_tpu_torch.ops.norm import instance_norm

    g = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for name, h, w, c, relu, _ in SITES:
        x = torch.randn((n, c, h, w), device="cuda", generator=g).contiguous(
            memory_format=torch.channels_last)
        gamma = torch.rand(c, device="cuda", generator=g) + 0.5
        beta = torch.randn(c, device="cuda", generator=g)
        whole = instance_norm(x, gamma, beta, relu=relu)[: n // 2]
        half = instance_norm(x[: n // 2], gamma, beta, relu=relu)
        rows.append({"site": name, "bit_equal": bool(torch.equal(whole, half)),
                     "max_abs_diff": float((whole - half).abs().max()),
                     "chunks_a_sample": {n // 2: fwd_plan(x[: n // 2]).chunks, n: fwd_plan(x).chunks}})
    return rows


def _with_static_scales(qparams: dict, scales: dict) -> dict:
    from fast_neural_style_transfer_tpu_torch.infer import quantized as q

    out = {n: dict(v) for n, v in qparams.items() if n != "res_blocks"}
    out["res_blocks"] = [{c: dict(p) for c, p in rb.items()} for rb in qparams["res_blocks"]]
    for name, s in scales.items():
        q._get(out, name)["act_scale"] = s
    return out


def _serve_in_process(flags: list, body: bytes, n: int) -> dict:
    """fnst-serve's ``main`` with ``flags`` in this process, on 127.0.0.1:0:
    ``n`` concurrent requests, then its shutdown."""
    from fast_neural_style_transfer_tpu_torch.serve import http as serve_http

    replies, real = [], serve_http.make_server

    def on_port_0(forward, **kw):
        kw.update(host="127.0.0.1", port=0)
        srv = real(forward, **kw)

        def post(_):
            conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1], timeout=120)
            try:
                conn.request("POST", "/stylize?format=png", body=body,
                             headers={"Content-Type": "image/jpeg"})
                resp = conn.getresponse()
                return resp.status, resp.read()
            finally:
                conn.close()

        def client():
            try:
                with ThreadPoolExecutor(max_workers=n) as pool:
                    replies.extend(pool.map(post, range(n)))
            finally:
                srv.shutdown()

        threading.Thread(target=client, daemon=True).start()
        return srv

    import signal as signal_mod

    before = signal_mod.getsignal(signal_mod.SIGTERM)
    serve_http.make_server = on_port_0
    try:
        serve_http.main(flags)
    finally:
        serve_http.make_server = real
        signal_mod.signal(signal_mod.SIGTERM, before)
    return {"replies": replies}


def phase_data_parallel_serving(seed: int) -> dict:
    """Replicas in one process (``Stylizer(sharding=)`` over ["cuda:0",
    "cuda:0"]) with the trained weights at B=8, 256x256: the main path is
    the f32 call, its counts set to 0 just before and read just after (14
    IN launches a chunk, two chunks). Against the unsharded Stylizer's B=8
    call: f32 max |du8| <= 1, bf16 SSIM >= 0.98; int8: each conv's
    shared scale bit-equal to the dynamic scale of the whole batch (the
    chunks' inputs laid end to end), conv1's to the unsharded B=8 call's
    (the same input bits), while the other convs' scales against that
    call and its |du8| are reported, beside the same call with the shared
    scales as static ones and the IN kernel at N=4 against N=8 at each
    site (int8's requantization amplifies the IN kernel's f32 roundings,
    which follow the batch the kernel sees). Under deterministic
    algorithms each B=4 chunk bit-equal to the unsharded Stylizer run on it
    alone (f32, bf16, f32 with preserve_color="luma", int8 with the shared
    scales as static ones); B=1 and B=3 run as one chunk. Then the
    inference CLI with --content_dir --data_parallel against the run
    without the flag (|du8| <= 1; both runs under deterministic
    algorithms: cuDNN's default convolutions differ in the last bits from
    run to run, which flips a u8 that the CLI's JPEG encoding can widen
    past 1, even between two runs without the flag) and
    fnst-serve --data_parallel answering 16 requests, both over every
    visible card."""
    from PIL import Image

    from fast_neural_style_transfer_tpu_torch.cli import begin_inference
    from fast_neural_style_transfer_tpu_torch.infer import Stylizer
    from fast_neural_style_transfer_tpu_torch.models import NUM_IN_SITES
    from fast_neural_style_transfer_tpu_torch.ops.cuda_norm import instance_norm_fwd
    from fast_neural_style_transfer_tpu_torch.parallel import make_mesh_plan

    params = Stylizer.load_params(str(CHECKPOINT))
    plan = make_mesh_plan(devices=["cuda:0", "cuda:0"])
    img = np.stack([smooth_image(DP_SIZE, DP_SIZE, seed=7100 + i)
                    for i in range(DP_SERVE_BATCH)])
    half = DP_SERVE_BATCH // 2
    out, main_launches, int8_scales = {}, None, {}
    for precision, color in (("f32", "off"), ("bf16", "off"), ("int8", "off"), ("f32", "luma")):
        one = Stylizer(params, precision=precision, preserve_color=color)
        rep = Stylizer(params, precision=precision, preserve_color=color,
                       sharding=plan.batch_sharding)
        if precision == "f32" and color == "off":
            reset_launch_counts()
            got = rep.stylize_u8(img)
            main_launches = instance_norm_fwd.launches
        else:
            got = rep.stylize_u8(img)
        want = one.stylize_u8(img)
        du8, score = _du8(got, want), float(ssim_card(got, want).min())
        rec, rec_one = [], []
        with deterministic_algorithms(), record_int8_scales(rec):
            rep_det = rep.stylize_u8(img)
        if precision == "int8":
            # each conv's shared scale must be the whole batch's max; the
            # unsharded B=8 call's equals it only where the conv's input is
            # the same bits (conv1: later inputs went through IN kernels
            # planned for N=8, not 4); that call with the shared scales as
            # static ones, against the replicas, leaves the IN plan's share
            with deterministic_algorithms(), record_int8_scales(rec_one):
                one.stylize_u8(img)
            one.qparams = _with_static_scales(one.qparams, {n: s for n, s, _, _ in rec})
            with deterministic_algorithms():
                b8_static = one.stylize_u8(img)
            same = [bool(a[1] == b[1]) for a, b in zip(rec, rec_one)]
            int8_scales = {
                "convs": len(rec),
                "shared_equals_whole_batch": all(bool(s == w) for _, s, w, _ in rec),
                "convs_where_chunk0_alone_differs": sum(bool(s != c) for _, s, _, c in rec),
                "equal_to_unsharded_b8": same,
                "max_rel_diff_to_unsharded_b8": max(
                    abs(float(a[1]) / float(b[1]) - 1.0) for a, b in zip(rec, rec_one)),
                "unsharded_b8_with_shared_static_max_abs_du8": _du8(b8_static, rep_det),
                "in_plan_n4_vs_n8": in_plan_follows_n(seed, DP_SERVE_BATCH)}
        with deterministic_algorithms():
            chunks = [one.stylize_u8(img[i * half:(i + 1) * half]) for i in range(2)]
        bit_equal = np.array_equal(np.concatenate(chunks), rep_det)
        ones = {}
        for b in (1, 3):
            before = instance_norm_fwd.launches
            rep.stylize_u8(img[:b])
            ones[b] = instance_norm_fwd.launches - before
        ok = (got.shape == img.shape and bit_equal
              and all(v == NUM_IN_SITES for v in ones.values())
              and (du8 <= 1 if precision == "f32" else
                   score >= 0.98 if precision == "bf16" else
                   int8_scales["convs"] == 15 and int8_scales["shared_equals_whole_batch"]
                   and int8_scales["equal_to_unsharded_b8"][0]))
        key = precision + ("_luma" if color == "luma" else "")
        out[key] = {"max_abs_du8": du8, "min_ssim": score}
        emit("data_parallel_serving", ok=ok, precision=precision, preserve_color=color,
             replicas=[str(d) for d in plan.devices], batch=DP_SERVE_BATCH,
             size=[DP_SIZE, DP_SIZE], max_abs_du8_vs_unsharded=du8,
             min_ssim_vs_unsharded=score,
             criterion={"f32": "max|du8|<=1", "bf16": "ssim>=0.98",
                        "int8": "each conv's shared scale the whole batch's, conv1's the "
                                "unsharded B=8 call's; chunks bit-equal (the other "
                                "convs' scales and du8 vs B=8 reported)"}[precision],
             chunks_bit_equal_to_unsharded_alone=bit_equal,
             int8_scales=int8_scales if precision == "int8" else None,
             in_launches_b1_b3=ones, card_deterministic_algorithms_for_bit_check=True)
        if not ok:
            fail(f"data-parallel serving ({key})")
    main_ok = main_launches == 2 * NUM_IN_SITES
    emit("data_parallel_serving_counts", ok=main_ok, in_fwd_launches=main_launches,
         expected=2 * NUM_IN_SITES)
    if not main_ok:
        fail("data-parallel serving: IN launches of the B=8 call")
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "c")
        os.makedirs(src)
        for i in range(DP_SERVE_BATCH):
            Image.fromarray(img[i]).save(os.path.join(src, f"{i}.png"))
        outs = {}
        for flags in ([], ["--data_parallel"]):
            d = os.path.join(tmp, "o" + str(len(flags)))
            with deterministic_algorithms():
                begin_inference.main(["--model_path", str(CHECKPOINT), "--content_dir", src,
                                      "--output_dir", d, "--batch_size",
                                      str(DP_SERVE_BATCH), *flags])
            outs[len(flags)] = np.stack([np.asarray(Image.open(
                os.path.join(d, f"{i}_stylized.jpg"))) for i in range(DP_SERVE_BATCH)])
        cli_du8 = _du8(outs[0], outs[1])
    buf = io.BytesIO()
    Image.fromarray(img[0]).save(buf, format="JPEG", quality=95)
    served = _serve_in_process(["--model", str(CHECKPOINT), "--data_parallel", "--size",
                                str(DP_SIZE)], buf.getvalue(), 16)
    statuses = [s for s, _ in served["replies"]]
    import torch

    ok = cli_du8 <= 1 and statuses == [200] * 16
    emit("data_parallel_cli_and_server", ok=ok, cards=torch.cuda.device_count(),
         cli_max_abs_du8_vs_without_flag=cli_du8, cli_deterministic_algorithms=True,
         server_statuses=statuses)
    if not ok:
        fail("data-parallel inference CLI or fnst-serve --data_parallel")
    return {"main_launches": main_launches, **out}

def dp_time_rank(plan, seed: int, per_rank: int) -> dict:
    """Host-clock walls of the data-parallel f32 step at 256x256 with
    ``per_rank`` images a rank (after two warm-up steps), and of the flat
    gradient all_reduce."""
    import torch

    from fast_neural_style_transfer_tpu_torch.train.state import create_train_state
    from fast_neural_style_transfer_tpu_torch.train.step import make_train_step

    net, vgg, u8, grams, _ = _train_inputs(str(plan.device), seed, DP_SIZE, per_rank)
    state, step = create_train_state(net), make_train_step(dropout=False, data=plan.data)
    walls = []
    for i in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, vgg, u8, grams)
        torch.cuda.synchronize()
        if i >= 2:
            walls.append((time.perf_counter() - t0) * 1e3)
    flat = torch.cat([p.detach().reshape(-1).clone() for p in net.parameters()])
    reduce_ms = []
    for i in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plan.data.all_reduce_(flat)
        torch.cuda.synchronize()
        if i:
            reduce_ms.append((time.perf_counter() - t0) * 1e3)
    return {"step_ms_p50": float(np.median(walls)), "all_reduce_ms_p50": float(np.median(reduce_ms)),
            "backend": plan.backend, "device": str(plan.device)}


def phase_data_parallel_cards(seed: int) -> None:
    """On a machine with two cards or more (not in ``all``): the
    data-parallel step over NCCL, a rank a card, at 256x256 f32, per rank
    p50 against the one-card step, card by card (global B=20 split, and 20
    a card); the device guard: ``Stylizer(device="cuda:1")`` against card
    0 (the same output, 14 IN launches), and a two-card replica plan at B=8
    against the unsharded Stylizer (f32 max |du8| <= 1)."""
    import torch

    from fast_neural_style_transfer_tpu_torch.infer import Stylizer
    from fast_neural_style_transfer_tpu_torch.models import NUM_IN_SITES
    from fast_neural_style_transfer_tpu_torch.ops.cuda_norm import instance_norm_fwd
    from fast_neural_style_transfer_tpu_torch.parallel import launch, make_mesh_plan

    cards = torch.cuda.device_count()
    if cards < 2:
        emit("data_parallel_cards", ran=False, cards=cards, reason="needs two cards or more")
        return
    params = Stylizer.load_params(str(CHECKPOINT))
    img = np.stack([smooth_image(DP_SIZE, DP_SIZE, seed=7300 + i) for i in range(DP_SERVE_BATCH)])
    with deterministic_algorithms():
        ref = Stylizer(params, precision="f32").stylize_u8(img)
        before = instance_norm_fwd.launches
        other = Stylizer(params, precision="f32", device="cuda:1")
        got1 = other.stylize_u8(img[:1])
        launches = instance_norm_fwd.launches - before
        got1_all = other.stylize_u8(img)
    rep = Stylizer(params, precision="f32",
                   sharding=make_mesh_plan(devices=["cuda:0", "cuda:1"]).batch_sharding)
    before = instance_norm_fwd.launches
    got2 = rep.stylize_u8(img)
    rep_launches = instance_norm_fwd.launches - before
    ok = (launches == NUM_IN_SITES and _du8(got1_all, ref) <= 1 and _du8(got2, ref) <= 1
          and rep_launches == 2 * NUM_IN_SITES and str(other.device) == "cuda:1")
    emit("device_guard_cards", ok=ok, cards=cards, stylizer_on_cuda1_launches_b1=launches,
         cuda1_vs_cuda0_max_abs_du8=_du8(got1_all, ref),
         cuda1_vs_cuda0_bit_equal=bool(np.array_equal(got1_all, ref)),
         two_card_replicas_max_abs_du8=_du8(got2, ref), two_card_replica_launches=rep_launches)
    if not ok:
        fail("the device guard on a second card")
    del other, rep
    free_card()
    one = {b: unsharded_step_ms(seed, DP_SIZE, b, reps=5) for b in (5, 10, DP_BATCH)}
    free_card()
    rows = []
    for n in sorted({2, min(cards, 4)}):
        for per_rank in (DP_BATCH // n, DP_BATCH):
            ranks = launch(dp_time_rank, n, (seed, per_rank), spatial=1, device="cuda")
            rows.append({"ranks": n, "per_rank_batch": per_rank, "global_batch": per_rank * n,
                         "backend": ranks[0]["backend"],
                         "step_ms_p50_per_rank": [r["step_ms_p50"] for r in ranks],
                         "grad_all_reduce_ms_p50_per_rank": [r["all_reduce_ms_p50"]
                                                            for r in ranks]})
            free_card()
    emit("data_parallel_cards", ran=True, cards=cards, size=[DP_SIZE, DP_SIZE],
         precision="f32", one_card_step_ms_p50_by_batch=one, runs=rows)



TOOLING_DRILL = {"total_steps": 24, "batch": 4, "ckpt_every": 8, "image_size": 256,
                 "log_every": 1}  # SIGTERM at total_steps // 2; bf16 (the drill's)
PARITY_SSIM = 0.98  # evidence/ssim_r5/final_40k.json's threshold


def counted_child(body: str, counts_file: str) -> list:
    """argv of a child that runs ``body`` (Python source) with the repo on
    its path and appends its kernel launch counts
    (``parallel.mesh.kernel_counts``) to ``counts_file`` as it exits."""
    prelude = (
        f"import atexit, json, sys; sys.path.insert(0, {str(REPO)!r})\n"
        "from fast_neural_style_transfer_tpu_torch.parallel.mesh import kernel_counts\n"
        f"atexit.register(lambda: open({counts_file!r}, 'a').write("
        "json.dumps(kernel_counts()) + '\\n'))\n")
    return [sys.executable, "-c", prelude + body]


def run_module_body(module: str, argv: list) -> str:
    """Source that runs ``module`` as ``python -m module *argv`` does
    (``runpy.run_module`` with ``alter_sys``)."""
    return (f"import runpy; sys.argv = {[module] + list(argv)!r}\n"
            f"runpy.run_module({module!r}, run_name='__main__', alter_sys=True)\n")


def child_launches(counts_file: str) -> dict:
    """The launches of every child that appended to ``counts_file``, summed
    by kernel."""
    total: dict = {}
    with open(counts_file) as f:
        for line in f:
            for name, c in json.loads(line).items():
                total[name] = total.get(name, 0) + c["launches"]
    return total


def tooling_pipeline(seed: int, data: str) -> dict:
    """``InputPipeline(transport="f32", prefetch=2)`` on the card: two
    epochs held at once equal their host batches (u8 and f32: no buffer
    reused while in flight); one f32 step on its first batch under
    deterministic algorithms against the same step on the u8 transport's
    first batch (loss 1e-5 relative), with the f32 step's launches."""
    import torch

    from fast_neural_style_transfer_tpu_torch.core.dtypes import Precision
    from fast_neural_style_transfer_tpu_torch.data import ImageFolderDataset, InputPipeline
    from fast_neural_style_transfer_tpu_torch.losses import (
        LossTaps,
        style_targets_from_features,
    )
    from fast_neural_style_transfer_tpu_torch.models import NUM_IN_SITES, TransformerNet
    from fast_neural_style_transfer_tpu_torch.models.vgg_weights import make_vgg, random_params
    from fast_neural_style_transfer_tpu_torch.ops.cuda_conv import conv2d_same_dx
    from fast_neural_style_transfer_tpu_torch.ops.cuda_norm import (
        instance_norm_bwd,
        instance_norm_fwd,
    )
    from fast_neural_style_transfer_tpu_torch.train.state import create_train_state
    from fast_neural_style_transfer_tpu_torch.train.step import exact_f32, make_train_step
    from fast_neural_style_transfer_tpu_torch.utils.image_io import u8_to_network

    prec = Precision.f32()
    exact_f32(torch.device("cuda"), prec)
    ds = ImageFolderDataset(data, (256, 256), seed=seed)
    pipes = {t: InputPipeline(ds, TRAIN_BATCH, seed=seed, prefetch=2, transport=t,
                              device="cuda") for t in ("u8", "f32")}
    held_equal = {}
    for t, pipe in pipes.items():
        want = list(pipe.host_batches(num_epochs=2))
        held = list(pipe.device_batches(num_epochs=2))
        held_equal[t] = len(held) == len(want) == 2 * len(ds) // TRAIN_BATCH and all(
            np.array_equal(h.cpu().numpy(), w) for h, w in zip(held, want))
    vgg = make_vgg(random_params(seed), "cuda")
    style = u8_to_network(torch.from_numpy(smooth_image(256, 256, seed=5))[None].cuda())
    with torch.no_grad():
        grams = [g.detach() for g in style_targets_from_features(
            vgg(style, LossTaps().style_taps, precision=prec))]

    def fresh_state():
        torch.manual_seed(seed)
        return create_train_state(
            TransformerNet().to("cuda", memory_format=torch.channels_last))

    parity_step = make_train_step(dropout=False)
    metrics, dtypes, launches = {}, {}, None
    with deterministic_algorithms():
        for t in ("u8", "f32"):
            state = fresh_state()
            batches = pipes[t].device_batches()
            batch = next(batches)
            if t == "f32":
                reset_launch_counts()
                reset_conv_counts()
            m = parity_step(state, vgg, batch, grams)
            metrics[t] = {k: float(m[k]) for k in ("loss", "grad_norm")}
            if t == "f32":
                torch.cuda.synchronize()
                launches = {"instance_norm_fwd": instance_norm_fwd.launches,
                            "instance_norm_bwd": instance_norm_bwd.launches,
                            "conv2d_same_dx": conv2d_same_dx.launches}
            batches.close()
            dtypes[t] = str(batch.dtype)
    rel = abs(metrics["f32"]["loss"] - metrics["u8"]["loss"]) / abs(metrics["u8"]["loss"])

    expected = {"instance_norm_fwd": NUM_IN_SITES, "instance_norm_bwd": NUM_IN_SITES,
                "conv2d_same_dx": 1}
    ok = (all(held_equal.values()) and rel <= 1e-5 and launches == expected
          and dtypes == {"u8": "torch.uint8", "f32": "torch.float32"})
    out = {"ok": ok, "batch": TRAIN_BATCH, "size": [256, 256], "precision": "f32",
           "prefetch": 2, "held_batches_equal_host": held_equal, "batch_dtypes": dtypes,
           "step": metrics, "loss_rel_f32_vs_u8": rel, "launches": launches,
           "expected_launches": expected}
    emit("tooling_pipeline", **out)
    return out


def transport_step_times(seed: int, data: str) -> dict:
    """Each transport of the input pipeline (two batches ahead) feeding the
    bf16 training step (the trainers' and the drill's precision) at B=20,
    256x256 on ``data``, alone on the card: the step's wall on the host
    clock (next batch, step, synchronize), p50 of 8 steps after 2, once
    each in turns (u8, f32, f32, u8)."""
    import torch

    from fast_neural_style_transfer_tpu_torch.core.dtypes import canonical_compute_dtype
    from fast_neural_style_transfer_tpu_torch.data import ImageFolderDataset, InputPipeline
    from fast_neural_style_transfer_tpu_torch.losses import (
        LossTaps,
        style_targets_from_features,
    )
    from fast_neural_style_transfer_tpu_torch.models import TransformerNet
    from fast_neural_style_transfer_tpu_torch.models.vgg_weights import make_vgg, random_params
    from fast_neural_style_transfer_tpu_torch.train.state import create_train_state
    from fast_neural_style_transfer_tpu_torch.train.step import make_train_step
    from fast_neural_style_transfer_tpu_torch.utils.image_io import u8_to_network

    prec = canonical_compute_dtype("bf16")
    ds = ImageFolderDataset(data, (256, 256), seed=seed)
    vgg = make_vgg(random_params(seed), "cuda")
    style = u8_to_network(torch.from_numpy(smooth_image(256, 256, seed=5))[None].cuda())
    with torch.no_grad():
        grams = [g.detach() for g in style_targets_from_features(
            vgg(style, LossTaps().style_taps, precision=prec))]
    p50 = {"u8": [], "f32": []}
    for t in ("u8", "f32", "f32", "u8"):
        torch.manual_seed(seed)
        state = create_train_state(
            TransformerNet().to("cuda", memory_format=torch.channels_last))
        step = make_train_step(precision=prec)
        batches = InputPipeline(ds, TRAIN_BATCH, seed=seed, prefetch=2, transport=t,
                                device="cuda").device_batches()
        walls = []
        try:
            for _ in range(10):
                t0 = time.perf_counter()
                step(state, vgg, next(batches), grams)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
        finally:
            batches.close()
        p50[t].append(float(np.median(walls[2:])))
    emit("tooling_transport_times", batch=TRAIN_BATCH, size=[256, 256], precision="bf16",
         prefetch=2, step_p50_ms_host_clock=p50)
    return p50


def tooling_drill(out: str, counts: str) -> dict:
    """The preemption drill as its users run it: ``soak.run_phase`` for
    phase_a (SIGTERM once at half way), then for phase_b (resume to the
    end), each child counting its launches into ``counts``."""
    from fast_neural_style_transfer_tpu_torch.tools import soak
    from fast_neural_style_transfer_tpu_torch.train.checkpoint import CheckpointManager

    def argv(o):
        return counted_child(soak._trainer_argv(o)[-1], counts)

    kw = {"trainer_argv": argv, "poll_s": 0.02, "stall_s": 120.0, "backoff_s": 0.0,
          "deadline_s": 300.0}
    t = time.perf_counter()
    rc_a = soak.run_phase(out, kill_at_step=soak.run_config(out)["total_steps"] // 2, **kw)
    sigterm_ckpt = CheckpointManager(os.path.join(out, "checkpoints")).latest_step()
    with open(os.path.join(out, "metrics.jsonl")) as f:
        rows_a = len(f.readlines())
    rc_b = soak.run_phase(out, **kw)
    return {"rc_a": rc_a, "rc_b": rc_b, "sigterm_ckpt": sigterm_ckpt, "rows_a": rows_a,
            "seconds": time.perf_counter() - t}


def phase_tooling(seed: int, reference_repo=None) -> dict:
    """Row 16's paths on the card. Two children start together, each
    counting its kernel launches (``counted_child``): ``cli.parity`` run as
    ``python -m`` on the trained checkpoint against the reference
    repository's ``StyleTransferNet`` on the CPU (a given checkout, else
    the stand-in ``tests/torch_reference_stand_in.py`` written to a temp
    dir), and the quickstart example as ``python -m``. Beside them the
    preemption drill runs from a thread (``tooling_drill``: 256x256, B=4,
    bf16, 24 steps, a checkpoint every 8, SIGTERM at 12, then resumed to
    24) while this thread checks the pipeline's f32 transport
    (``tooling_pipeline``). Then the loss curves the drill's trainer
    plotted (or the skip line where matplotlib is absent), and last the
    transports' step times, alone on the card (``transport_step_times``)."""
    import importlib.util

    from PIL import Image

    from fast_neural_style_transfer_tpu_torch.models import NUM_IN_SITES
    from fast_neural_style_transfer_tpu_torch.tools import soak
    from fast_neural_style_transfer_tpu_torch.utils.visualization import plot_after_training

    given_reference = reference_repo is not None
    with tempfile.TemporaryDirectory() as tmp:
        data = _write_jpegs(os.path.join(tmp, "data"), 40, 240, seed=2000 + seed)
        if not given_reference:
            sys.path.insert(0, str(REPO / "tests"))
            from torch_reference_stand_in import write_reference_repo

            reference_repo = write_reference_repo(os.path.join(tmp, "reference"))
        content = os.path.join(tmp, "content.jpg")
        Image.fromarray(smooth_image(256, 256, seed=11)).save(content, quality=95)

        out = os.path.join(tmp, "drill")
        drill_counts = os.path.join(tmp, "drill.counts")
        rc = soak.run_config(out, create=True, dataset_dir=data, device=None,
                             **TOOLING_DRILL)
        children = {}
        for name, module, argv in (
                ("parity", "fast_neural_style_transfer_tpu_torch.cli.parity",
                 ["--reference_pth", str(CHECKPOINT), "--content", content,
                  "--reference_repo", reference_repo, "--output_dir",
                  os.path.join(tmp, "parity")]),
                ("quickstart", "fast_neural_style_transfer_tpu_torch.examples.quickstart",
                 [os.path.join(tmp, "quickstart")])):
            counts = os.path.join(tmp, f"{name}.counts")
            children[name] = (subprocess.Popen(
                counted_child(run_module_body(module, argv), counts), cwd=str(REPO),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), counts)
        try:
            with ThreadPoolExecutor(1) as pool:
                drilled = pool.submit(tooling_drill, out, drill_counts)
                pipeline = tooling_pipeline(seed, data)
                results = {}
                for name, (proc, counts) in children.items():
                    stdout, stderr = proc.communicate(timeout=300)
                    results[name] = (proc.returncode, stdout, stderr, child_launches(counts))
                drill = drilled.result()
        finally:
            for proc, _ in children.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()

        rep = soak.evidence(out)
        with open(os.path.join(out, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        rows_a, sigterm_ckpt = drill["rows_a"], drill["sigterm_ckpt"]
        resumed_first = rows[rows_a]["step"] if len(rows) > rows_a else None
        finite = all(np.isfinite(r[k]) for r in rows
                     for k in ("loss", "content_loss", "style_loss", "tv_loss"))
        steps = rc["total_steps"]
        drill_launches = child_launches(drill_counts)
        drill_expected = {"instance_norm_fwd": NUM_IN_SITES * steps,
                          "instance_norm_bwd": NUM_IN_SITES * steps,
                          "conv2d_same_dx": steps}
        drill_ok = bool(
            drill["rc_a"] == 0 and drill["rc_b"] == 0
            and sigterm_ckpt is not None and steps // 2 <= sigterm_ckpt < steps
            and rep["max_step"] == steps and rep["duplicate_steps_after_resume"] == 0
            and resumed_first == sigterm_ckpt + 1 and finite
            and rep["nonfinite_skips"] == 0 and drill_launches == drill_expected)
        emit("tooling_drill", ok=drill_ok, config=rc, precision="bf16",
             sigterm_checkpoint=sigterm_ckpt, resumed_first_step=resumed_first,
             report=rep, all_losses_finite=finite, seconds=drill["seconds"],
             launches=drill_launches, expected_launches=drill_expected)

        pngs = sorted(f for f in os.listdir(out) if f.endswith(".png"))
        has_mpl = importlib.util.find_spec("matplotlib") is not None
        skip_line = None
        if not pngs:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                plot_after_training(out)
            skip_line = buf.getvalue().strip()
        curves_ok = (pngs == ["content_loss.png", "loss.png", "style_loss.png", "tv_loss.png"]
                     if has_mpl else
                     not pngs and skip_line.startswith("loss-curve plotting skipped:"))
        emit("tooling_loss_curves", ok=curves_ok, matplotlib=has_mpl, pngs=pngs,
             skip_line=skip_line)

        rc_p, stdout, stderr, parity_launches = results["parity"]
        lines = [ln for ln in stdout.splitlines() if ln.startswith("{")]
        record = json.loads(lines[-1]) if lines else {}
        parity_ok = bool(rc_p == 0 and record.get("value", 0.0) >= PARITY_SSIM
                         and record.get("pass") is True
                         and parity_launches.get("instance_norm_fwd") == NUM_IN_SITES
                         and os.path.exists(os.path.join(tmp, "parity", "parity_ours.jpg")))
        saved = [os.path.join(tmp, "parity", f"parity_{side}.jpg")
                 for side in ("ours", "reference")]
        du8 = (int(np.abs(np.asarray(Image.open(saved[0]), np.int16)
                          - np.asarray(Image.open(saved[1]), np.int16)).max())
               if all(map(os.path.exists, saved)) else None)
        emit("tooling_parity", ok=parity_ok, exit_code=rc_p, record=record,
             reference=reference_repo if given_reference else "stand-in",
             saved_images_max_du8=du8, launches=parity_launches,
             expected_instance_norm_fwd=NUM_IN_SITES,
             stderr_tail=stderr[-2000:] if not parity_ok else "")

        rc_q, stdout, stderr, qs_launches = results["quickstart"]
        qs_dir = os.path.join(tmp, "quickstart")
        qs_files = sorted(os.listdir(qs_dir)) if os.path.isdir(qs_dir) else []
        # 3 train steps at 64x64, one stylize at 100x156 (bucket 128x192)
        qs_expected = {"instance_norm_fwd": 4 * NUM_IN_SITES,
                       "instance_norm_bwd": 3 * NUM_IN_SITES, "conv2d_same_dx": 3}
        qs_ok = (rc_q == 0 and qs_files == ["model.onnx", "model.pth", "stylized.jpg"]
                 and qs_launches == qs_expected)
        emit("tooling_quickstart", ok=qs_ok, exit_code=rc_q, files=qs_files,
             launches=qs_launches, expected_launches=qs_expected,
             stdout_tail=stdout[-1000:], stderr_tail=stderr[-2000:] if not qs_ok else "")
        transport_step_times(seed, data)
    failed = [name for name, ok in (("pipeline", pipeline["ok"]), ("drill", drill_ok),
                                    ("loss_curves", curves_ok), ("parity", parity_ok),
                                    ("quickstart", qs_ok)) if not ok]
    if failed:
        fail(f"tooling phase: {failed}")
    return {"pipeline": pipeline["launches"], "parity": parity_launches,
            "drill": drill_launches, "quickstart": qs_launches}


# (C, H, W, pad, relu, upsample) of every reflect pad of the serving paths:
# the stylizer at 512^2 and 256^2 (conv1, conv2, the res blocks, final_conv)
# and the AdaIN decoder at 512^2 (AdaIN and StyTr²)
PAD_SITES = [(3, 512, 512, 4, False, 1), (64, 256, 256, 1, False, 1),
             (256, 128, 128, 1, False, 1), (32, 512, 512, 4, False, 1),
             (3, 256, 256, 4, False, 1), (64, 128, 128, 1, False, 1),
             (256, 64, 64, 1, False, 1), (32, 256, 256, 4, False, 1),
             (512, 64, 64, 1, False, 1), (256, 64, 64, 1, True, 2),
             (256, 128, 128, 1, True, 1), (128, 128, 128, 1, True, 2),
             (128, 256, 256, 1, True, 1), (64, 256, 256, 1, True, 2),
             (64, 512, 512, 1, True, 1)]
# the shapes the kernel table times, at B=8 bf16
PAD_TIMED = [(256, 128, 128, 1, False, 1), (32, 512, 512, 4, False, 1),
             (3, 512, 512, 4, False, 1), (64, 256, 256, 1, True, 2)]


def phase_reflect_pad(seed: int) -> dict:
    """The reflect-pad kernel at every pad site of the serving paths (bf16
    at B=1 and 8, f32 at B=1) against its plain version and against the
    route it replaced (ReLU, nearest x2 upsample and F.pad, each its own
    pass), bit for bit, with -0 in the input; then at PAD_TIMED (B=8,
    bf16) the kernel's device time (CUDA-graph replay, back to back, so an
    input under the 50 MB L2 is warm) beside its bound (read x once, write
    y once at HBM speed), the plain version's time and the replaced
    route's."""
    import torch
    import torch.nn.functional as F

    from fast_neural_style_transfer_tpu_torch.ops import conv, cuda_pad

    def replaced(x, pad, relu, up):
        if relu:
            x = torch.relu(x)
        if up != 1:
            x = F.interpolate(x, scale_factor=up, mode="nearest")
            x = x.contiguous(memory_format=torch.channels_last)
        x = F.pad(x, (pad, pad, pad, pad), mode="reflect")
        return x.contiguous(memory_format=torch.channels_last)

    gen = torch.Generator(device="cuda").manual_seed(seed)
    bad, err = [], 0.0
    with torch.inference_mode():
        for c, h, w, pad, relu, up in PAD_SITES:
            for n, dtype in ((1, torch.bfloat16), (8, torch.bfloat16), (1, torch.float32)):
                x = torch.randn((n, h, w, c), generator=gen, device="cuda").to(dtype)
                x[..., ::5] = -0.0
                x = x.permute(0, 3, 1, 2)
                before = conv.reflect_pad_hw.launches
                y = conv.reflect_pad_hw(x, pad, relu=relu, upsample=up)
                launched = conv.reflect_pad_hw.launches - before
                torch.cuda.synchronize()
                case = [c, h, w, pad, relu, up, n, str(dtype)]
                for name, want in (("plain", cuda_pad.reflect_pad_reference(
                        x, pad, relu=relu, upsample=up)), ("replaced", replaced(x, pad, relu, up))):
                    if launched != 1 or not torch.equal(bits(y), bits(want)):
                        bad.append(case + [name])
                    if y.shape == want.shape:
                        err = max(err, float((y.float() - want.float()).abs().max()))
        times = []
        for c, h, w, pad, relu, up in PAD_TIMED:
            x = torch.randn((8, h, w, c), generator=gen, device="cuda").to(torch.bfloat16)
            x = x.permute(0, 3, 1, 2)
            y = cuda_pad.reflect_pad(x, pad, relu=relu, upsample=up)
            moved = (x.numel() + y.numel()) * x.element_size()
            times.append({
                "shape": [8, c, h, w], "pad": pad, "relu": relu, "upsample": up,
                "plan": cuda_pad.plan_pad(8, c, h, w, 2, pad, up, x.data_ptr())._asdict(),
                "ms": graph_ms(lambda: cuda_pad.reflect_pad(x, pad, relu=relu, upsample=up)),
                "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
                "plain_ms": graph_ms(lambda: cuda_pad.reflect_pad_reference(
                    x, pad, relu=relu, upsample=up)),
                "replaced_ms": graph_ms(lambda: replaced(x, pad, relu, up)),
                "library_ms": graph_ms(lambda: F.pad(x, (pad,) * 4, mode="reflect").contiguous(
                    memory_format=torch.channels_last)),
            })
            times[-1]["roofline_pct"] = 100 * times[-1]["bound_ms"] / times[-1]["ms"]
    ok = not bad
    emit("reflect_pad", ok=ok, sites=len(PAD_SITES), mismatches=bad, max_abs_err=err,
         times=times)
    if not ok:
        fail("reflect_pad phase")
    return {"times": times, "max_abs_err": err}


# the moment-attention kernel's three sites in a 512^2 AdaAttN forward with a
# 512^2 style, at B=8: (B, queries, style positions, key width, value width)
MOMENT_SITES = [(8, 16384, 4096, 448, 256), (8, 4096, 4096, 960, 512),
                (8, 1024, 1024, 1472, 512)]
# beside them: no multiple of the 64-row tiles, one ragged key tile at the
# narrowest widths, and |M| >> S (values offset by mu = 100)
MOMENT_EDGES = [((2, 1000, 1000, 448, 256), 0.0), ((3, 200, 70, 192, 128), 0.0),
                ((2, 1024, 1024, 960, 512), 100.0)]


def moment_operands(b, nq, nk, dqk, dv, mu, gen):
    """bf16 operands on the card as tests/test_torch_adaattn.py draws them:
    logits of std ~4, values N(mu + a channel offset, 1), c the last dv
    channels of a key buffer (read in place, row stride dqk)."""
    import torch

    a = (4.0 / dqk ** 0.5) ** 0.5
    q = (torch.randn(b, nq, dqk, generator=gen, device="cuda") * a).bfloat16()
    key = torch.randn(b, nq, dqk, generator=gen, device="cuda").bfloat16()
    k = (torch.randn(nk, dqk, generator=gen, device="cuda") * a).bfloat16()
    v = (torch.randn(nk, dv, generator=gen, device="cuda") + mu
         + torch.randn(1, dv, generator=gen, device="cuda")).bfloat16()
    return q, k, v, key[..., dqk - dv:]


def moment_composition(q, k, v, c, dtype, block: int = 4096):
    """AdaAttN's attention as the official code writes it (bmm, softmax,
    bmm, the epilogue) on the unshifted values, in blocks of queries:
    float32 from the bf16 operands (what the kernel is held to), or bf16
    throughout (the library's time)."""
    import torch

    kt, v1 = k.to(dtype).t(), v.to(dtype)
    v2 = v1.square()
    out = []
    for i in range(0, q.shape[1], block):
        a = torch.softmax(q[:, i:i + block].to(dtype) @ kt, -1)
        m = a @ v1
        s = torch.sqrt(torch.relu(a @ v2 - m.square()))
        out.append(s * c[:, i:i + block].to(dtype) + m)
    return torch.cat(out, 1)


def phase_moment_attention(seed: int) -> dict:
    """AdaAttN's moment-attention kernel (``csrc/moment_attention.cu``): one
    launch at each site of MOMENT_SITES and MOMENT_EDGES against the float32
    composition of the same bf16 operands, at tests/test_torch_adaattn.py's
    tolerances (mean error within 0.4 % of the mean |output|, 99.9th
    percentile within 5 %, worst within 60 %: bf16 weights, values and
    output, and a square root where the variance is near 0); then a bf16
    ``AttentionalStylizer`` serving 512^2-bucket requests through
    ``MicroBatcher``, its launch counter set to 0 just before: 3 launches a
    batch, as the stylizer's own ``attention_launches``; then at each site
    the kernel's device time beside its bound (operations at the bf16 peak
    or bytes at HBM speed, the larger: q, c and the output once, k and the
    values once a batch), the plain version's (float32) and the library's
    (the bf16 bmm / softmax / bmm composition)."""
    import torch

    from fast_neural_style_transfer_tpu_torch.infer.adaattn import AttentionalStylizer
    from fast_neural_style_transfer_tpu_torch.models.adaattn import AdaAttN
    from fast_neural_style_transfer_tpu_torch.models.vgg_weights import random_params
    from fast_neural_style_transfer_tpu_torch.ops import cuda_moment_attention as cma
    from fast_neural_style_transfer_tpu_torch.serve.batcher import MicroBatcher

    gen = torch.Generator(device="cuda").manual_seed(seed)
    checks, bad, err = [], [], 0.0
    with torch.inference_mode():
        for shape, mu in [(s, 0.0) for s in MOMENT_SITES] + MOMENT_EDGES:
            q, k, v, c = moment_operands(*shape, mu, gen)
            mv = cma.prepare_values(v.float(), torch.bfloat16)
            before = cma.moment_attention.launches
            got = cma.moment_attention(q, k, mv, c)
            launched = cma.moment_attention.launches - before
            want = moment_composition(q, k, v, c, torch.float32)
            d = (got.float() - want).abs()
            scale = want.abs().mean().item()
            row = {"shape": list(shape), "mu": mu, "launches": launched,
                   "mean_err": d.mean().item(), "mean_abs": scale,
                   "p999_err": torch.quantile(d.flatten()[:1 << 24], 0.999).item(),
                   "max_err": d.max().item()}
            checks.append(row)
            err = max(err, row["max_err"])
            if (launched != 1 or row["mean_err"] >= 0.004 * scale
                    or row["p999_err"] >= 0.05 * max(scale, 1.0)
                    or row["max_err"] >= 0.6 * max(scale, 1.0)):
                bad.append(row)
            del q, k, v, c, mv, got, want, d

    torch.manual_seed(seed)
    sty = AttentionalStylizer(AdaAttN().state_dict(), random_params(seed), precision="bf16",
                              device="cuda")
    sty.set_style_u8(smooth_image(512, 512, seed))
    sty.stylize_u8(smooth_image(512, 512, seed + 1)[None])  # cuDNN's plans, off the count
    batcher = MicroBatcher(sty.stylize_u8, max_batch=8, max_wait_ms=5.0, bucket_multiple=64)
    rng = np.random.default_rng(seed)
    images = [smooth_image(int(h), int(w), seed + 2 + i)
              for i, (h, w) in enumerate(rng.integers(449, 513, (24, 2)))]
    cma.moment_attention.launches = 0
    before = sty.attention_launches
    try:
        outs = [f.result(timeout=600) for f in [batcher.submit(im) for im in images]]
    finally:
        batcher.close()
    served = {"requests": len(images), "batches": batcher.stats.batches,
              "launches": cma.moment_attention.launches,
              "attention_launches": sty.attention_launches - before,
              "shapes_ok": all(o.shape == im.shape for o, im in zip(outs, images))}
    if not (served["shapes_ok"] and served["launches"] == 3 * served["batches"]
            == served["attention_launches"]):
        bad.append({"serving": served})
    del sty

    times = []
    with torch.inference_mode():
        for b, nq, nk, dqk, dv in MOMENT_SITES:
            q, k, v, c = moment_operands(b, nq, nk, dqk, dv, 0.0, gen)
            mv = cma.prepare_values(v.float(), torch.bfloat16)
            flops = 2.0 * b * nq * nk * (dqk + 2 * dv)
            moved = (b * nq * (dqk + 2 * dv) + nk * (dqk + dv)) * 2
            bound_ms, bound_by = bound(moved, flops, "bfloat16")
            row = {"shape": [b, nq, nk, dqk, dv],
                   "ms": cuda_ms(lambda: cma.moment_attention(q, k, mv, c), iters=10),
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "plain_ms": cuda_ms(lambda: cma.moment_attention_reference(q, k, mv, c),
                                       iters=3, warmup=1),
                   "library_ms": cuda_ms(lambda: moment_composition(q, k, v, c, torch.bfloat16),
                                         iters=3, warmup=1)}
            row["roofline_pct"] = 100 * bound_ms / row["ms"]
            times.append(row)
            del q, k, v, c, mv
    ok = not bad
    emit("moment_attention", ok=ok, checks=checks, mismatches=bad, serving=served, times=times)
    if not ok:
        fail("moment_attention phase")
    return {"max_abs_err": err, "serving": served, "times": times}


# the final conv's outputs on the main path (N, H, W): the serving batches
# of 1 to 8 at 256^2 and 512^2 and one inference-CLI size; beside them the
# smallest sides, a strip boundary, odd and ragged sides, a tall thin image
RGB_SHAPES = [(n, s, s) for s in (256, 512) for n in range(1, 9)] + [(1, 260, 388),
                                                                      (2, 260, 388)]
RGB_EDGES = [(1, 5, 5), (2, 7, 121), (3, 9, 241), (1, 130, 7), (2, 33, 250), (1, 1000, 17)]
RGB_TIMED = [(8, 512, 512), (1, 256, 256)]


def rgb_operands(n, h, w, gen):
    """bf16 on the card, as the stylizer hands them to the final conv: the
    reflect-padded post-ReLU activation, a channels_last weight of the
    default init's scale, a bias."""
    import torch

    from fast_neural_style_transfer_tpu_torch.ops import cuda_pad

    x = torch.relu(torch.randn((n, h, w, 32), generator=gen, device="cuda")).bfloat16()
    xp = cuda_pad.reflect_pad(x.permute(0, 3, 1, 2), 4)
    wt = (torch.randn((3, 32, 9, 9), generator=gen, device="cuda") * 0.02).bfloat16()
    b = (torch.randn(3, generator=gen, device="cuda") * 0.1).bfloat16()
    return xp, wt.contiguous(memory_format=torch.channels_last), b


def rgb_error(got, want) -> dict:
    """How far the kernel's bf16 output lies from the plain version's: the
    largest gap in bf16 rounding steps of the plain value (ulp 2^-7 |v| at
    most, and 1e-4 near 0), and the share of outputs that differ at all."""
    d = (got.float() - want.float()).abs()
    steps = d / (2.0 ** -7 * want.float().abs() + 1e-4)
    return {"max_abs_err": d.max().item(), "max_steps": steps.max().item(),
            "differ_share": (d > 0).float().mean().item()}


def phase_conv_to_rgb(seed: int) -> dict:
    """The stylizer's final-conv kernel (``csrc/conv_to_rgb.cu``): one launch
    at each shape of RGB_SHAPES and RGB_EDGES against its plain version
    (float32 F.conv2d of the same bf16 operands), every output within one
    bf16 rounding step of it (1e-4 near 0), with a channels_last and a
    contiguous weight and without a bias; then a bf16 Stylizer's forward
    replayed from its CUDA graph under torch.profiler: one launch counted
    and one ``conv_to_rgb_kernel`` in the device trace, no TF32 kernel; an
    eager bf16 forward counts one, a float32 forward, a bf16 forward that
    needs a gradient and a bf16 ArbitraryStylizer forward none; then at
    RGB_TIMED the kernel's time (CUDA events over 10 launches, and over
    replays of a CUDA graph of 20, which leaves out the host's launch cost,
    most of a B=1 256^2 launch) beside its bound (operations at the bf16
    peak or bytes at HBM speed, the larger: x before the pad, y and the
    weights once), the plain version's and F.conv2d's in bf16 (the cuDNN
    route it replaced)."""
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from fast_neural_style_transfer_tpu_torch.core.dtypes import Precision
    from fast_neural_style_transfer_tpu_torch.infer import Stylizer
    from fast_neural_style_transfer_tpu_torch.infer.adain import ArbitraryStylizer
    from fast_neural_style_transfer_tpu_torch.models import TransformerNet
    from fast_neural_style_transfer_tpu_torch.models.adain import AdaINDecoder
    from fast_neural_style_transfer_tpu_torch.models.vgg_weights import random_params
    from fast_neural_style_transfer_tpu_torch.ops import cuda_conv_rgb as rgb

    gen = torch.Generator(device="cuda").manual_seed(seed)
    checks, bad, err = [], [], 0.0
    with torch.inference_mode():
        for i, shape in enumerate(RGB_SHAPES + RGB_EDGES):
            xp, wt, b = rgb_operands(*shape, gen)
            variants = [("channels_last", wt, b)]
            if i == 0 or shape in RGB_EDGES:
                variants += [("contiguous", wt.contiguous(), b), ("no_bias", wt, None)]
            for name, w_, b_ in variants:
                before = rgb.conv_to_rgb.launches
                got = rgb.conv_to_rgb(xp, w_, b_)
                launched = rgb.conv_to_rgb.launches - before
                torch.cuda.synchronize()
                row = {"shape": list(shape), "weight": name, "launches": launched,
                       "plan": rgb.plan_rgb(*shape, rgb._sms(xp.device))._asdict(),
                       **rgb_error(got, rgb.conv_to_rgb_reference(xp, w_, b_))}
                checks.append(row)
                err = max(err, row["max_abs_err"])
                if launched != 1 or tuple(got.shape) != (shape[0], 3, *shape[1:]) or not (
                        row["max_steps"] <= 1.0) or not got.is_contiguous(
                        memory_format=torch.channels_last):
                    bad.append(row)
            del xp, wt, b, got

    torch.manual_seed(seed)
    net = TransformerNet()
    with torch.no_grad():
        net.final_conv.conv.weight.mul_(5.0)  # a spread output
    sty = Stylizer(net.state_dict(), precision="bf16")
    x = np.random.default_rng(seed).integers(0, 256, (2, 256, 256, 3), np.uint8)
    before = rgb.conv_to_rgb.launches
    eager = sty.stylize_u8(x)
    counted = {"eager_bf16": rgb.conv_to_rgb.launches - before}
    sty.stylize_u8(x)  # the key's second call: captured
    torch.cuda.synchronize()
    replays, before = sty.graph_replays, rgb.conv_to_rgb.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        replayed = sty.stylize_u8(x)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    replay = {"replayed": sty.graph_replays - replays,
              "counted": rgb.conv_to_rgb.launches - before,
              "traced": sum(bool(re.search(r"\bconv_to_rgb_kernel\b", n)) for n in names),
              "traced_tf32": sum("tf32" in n for n in names),
              "same_output": bool(np.array_equal(eager, replayed))}
    net_card = TransformerNet().to("cuda", memory_format=torch.channels_last)
    u = torch.rand((1, 64, 64, 3), generator=gen, device="cuda")
    before = rgb.conv_to_rgb.launches
    with torch.no_grad():
        net_card(u)  # float32
    net_card(u, precision=Precision.bf16())  # bf16 with the weights' gradients on
    counted["f32_and_grad"] = rgb.conv_to_rgb.launches - before
    ada = ArbitraryStylizer(AdaINDecoder().state_dict(), random_params(seed), precision="bf16")
    ada.set_style_u8(smooth_image(256, 256, seed))
    before = rgb.conv_to_rgb.launches
    ada.stylize_u8(x)
    counted["adain_bf16"] = rgb.conv_to_rgb.launches - before
    served = {**counted, "replay": replay}
    if not (counted["eager_bf16"] == 1 and counted["f32_and_grad"] == 0
            and counted["adain_bf16"] == 0 and replay["replayed"] == 1
            and replay["counted"] == replay["traced"] == 1 and replay["traced_tf32"] == 0
            and replay["same_output"]):
        bad.append({"serving": served})
    del sty, ada, net_card

    times = []
    with torch.inference_mode():
        for n, h, w in RGB_TIMED:
            xp, wt, b = rgb_operands(n, h, w, gen)
            flops = 2.0 * n * h * w * 3 * 32 * 81
            moved = (n * h * w * (32 + 3) + wt.numel() + b.numel()) * 2
            bound_ms, bound_by = bound(moved, flops, "bfloat16")
            row = {"shape": [n, h, w],
                   "plan": rgb.plan_rgb(n, h, w, rgb._sms(xp.device))._asdict(),
                   "ms": cuda_ms(lambda: rgb.conv_to_rgb(xp, wt, b), iters=10),
                   "graph_ms": graph_ms(lambda: rgb.conv_to_rgb(xp, wt, b)),
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "plain_ms": cuda_ms(lambda: rgb.conv_to_rgb_reference(xp, wt, b), iters=10),
                   "library_ms": cuda_ms(lambda: F.conv2d(xp, wt, b), iters=10)}
            row["roofline_pct"] = 100 * bound_ms / row["ms"]
            times.append(row)
            del xp, wt, b
    ok = not bad
    emit("conv_to_rgb", ok=ok, checks=checks, mismatches=bad, serving=served, times=times)
    if not ok:
        fail("conv_to_rgb phase")
    return {"max_abs_err": err, "serving": served, "times": times}


PHASES = ("kernels", "trained_weights", "serving", "training", "train_parity",
          "multi_style", "video", "adain", "export", "int8", "spatial", "spatial_train",
          "spatial_adain", "data_parallel", "data_space", "data_parallel_serving", "tooling",
          "times", "train_times", "spatial_times", "in_fwd_budgets", "in_bwd_budgets",
          "reflect_pad", "moment_attention", "conv_to_rgb")
# recorded findings, run on request only
EXTRA_PHASES = ("int8_sensitivity", "train_parity_sensitivity", "spatial_profile",
                "data_parallel_cards")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reference_repo", default=None,
                    help="a reference checkout for the tooling phase's fnst-parity "
                         "(default: the stand-in tests/torch_reference_stand_in.py)")
    ap.add_argument("--phases", default="all",
                    help=f"comma-separated subset of {','.join(PHASES + EXTRA_PHASES)} "
                         f"(the build always runs; {','.join(EXTRA_PHASES)} only on request); "
                         "'all' also prints the kernels line")
    args = ap.parse_args()
    phases = PHASES if args.phases == "all" else tuple(args.phases.split(","))
    unknown = set(phases) - set(PHASES + EXTRA_PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    if not (REPO / "fast_neural_style_transfer_tpu_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository (package "
              "fast_neural_style_transfer_tpu_torch not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    t0 = time.perf_counter()
    seconds = {}

    def run(name, fn, *args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t
        return out

    dev = phase_device()
    run("build", phase_build)
    err = {}
    if "kernels" in phases:
        err["in_fwd"] = run("kernels", phase_kernel_vs_plain, args.seed)
        err["in_bwd"] = run("kernels", phase_in_bwd_vs_plain, args.seed)
        err["affine_fwd"], err["affine_bwd"] = run("kernels", phase_affine_vs_plain, args.seed)
        err["conv"] = run("kernels", phase_conv_bwd_vs_plain, args.seed)
        err["in_stats"] = run("kernels", phase_in_stats_vs_plain, args.seed)
        err["adain_in"] = run("kernels", phase_adain_in_vs_plain, args.seed)
        err["sharded"] = run("kernels", phase_sharded_in_vs_plain, args.seed)
    if "trained_weights" in phases:
        run("trained_weights", phase_trained_weights)
    served = run("serving", phase_serving) if "serving" in phases else None
    trained = run("training", phase_training, args.seed) if "training" in phases else None
    if "train_parity" in phases:
        run("train_parity", phase_train_parity, args.seed)
        run("train_parity", phase_train_parity, args.seed, variant="onepass",
            norm_method="onepass")
    multi = run("multi_style", phase_multi_style, args.seed) if "multi_style" in phases else None
    video = run("video", phase_video, args.seed) if "video" in phases else None
    adain = run("adain", phase_adain, args.seed) if "adain" in phases else None
    exported = (run("export", phase_export, args.seed, adain and adain["decoder"])
                if "export" in phases else None)
    int8 = run("int8", phase_int8, args.seed) if "int8" in phases else None
    spatial = run("spatial", phase_spatial, args.seed) if "spatial" in phases else None
    spatial_train = (run("spatial_train", phase_spatial_train, args.seed)
                     if "spatial_train" in phases else None)
    spatial_adain = (run("spatial_adain", phase_spatial_adain, args.seed,
                         adain and adain["decoder"]) if "spatial_adain" in phases else None)
    dparallel = (run("data_parallel", phase_data_parallel, args.seed)
                 if "data_parallel" in phases else None)
    dspace = run("data_space", phase_data_space, args.seed) if "data_space" in phases else None
    dserve = (run("data_parallel_serving", phase_data_parallel_serving, args.seed)
              if "data_parallel_serving" in phases else None)
    tooling = (run("tooling", phase_tooling, args.seed, args.reference_repo)
               if "tooling" in phases else None)
    if "data_parallel_cards" in phases:
        run("data_parallel_cards", phase_data_parallel_cards, args.seed)
    if "int8_sensitivity" in phases:
        run("int8_sensitivity", phase_int8_sensitivity, args.seed)
    if "train_parity_sensitivity" in phases:
        run("train_parity_sensitivity", phase_train_parity_sensitivity, args.seed)
    if "spatial_profile" in phases:
        run("spatial_profile", phase_spatial_profile, args.seed)
    times = run("times", phase_times, args.seed) if "times" in phases else None
    ttimes = run("train_times", phase_train_times, args.seed) if "train_times" in phases else None
    stimes = (run("spatial_times", sharded_in_times, args.seed)
              if "spatial_times" in phases else None)
    if "in_fwd_budgets" in phases:
        run("in_fwd_budgets", phase_in_fwd_budgets, args.seed)
    if "in_bwd_budgets" in phases:
        run("in_bwd_budgets", phase_in_bwd_budgets, args.seed)
    pads = run("reflect_pad", phase_reflect_pad, args.seed) if "reflect_pad" in phases else None
    moments = (run("moment_attention", phase_moment_attention, args.seed)
               if "moment_attention" in phases else None)
    rgbs = run("conv_to_rgb", phase_conv_to_rgb, args.seed) if "conv_to_rgb" in phases else None
    emit("done", seconds=time.perf_counter() - t0, phases=list(phases),
         phase_seconds=seconds)
    if phases == PHASES:
        b8 = times["per_forward"][8]
        in_fwd = ttimes["kernels"][("in_fwd", "float32")]
        in_bwd = ttimes["kernels"][("in_bwd", "float32")]
        conv = ttimes["kernels"][("conv_dx", "float32")]
        vk = video["kernel_times"]
        src = "fast_neural_style_transfer_tpu_torch/csrc/"
        kernels = [{
            "name": "instance_norm_fwd",
            "route": "cuda",
            "source": src + "instance_norm.cu",
            "replaces": "fast_neural_style_transfer_tpu/ops/pallas_norm.py:61",
            "launches": served["launches"],
            "launches_by_route": served["launches_by_route"],
            "launches_multi_style": multi["counts"]["instance_norm_fwd"],
            "launches_adain": adain["counts"]["instance_norm_fwd"],
            "max_abs_err": max(err["in_fwd"], err["affine_fwd"], err["adain_in"],
                               int8["in_max_abs_err"], exported["in_max_abs_err"]),
            # the serving path: the 14 sites of one 256x256 bf16 forward at B=8
            "ms": b8["ms"], "plain_ms": b8["plain_ms"],
            "bound_ms": b8["bound_ms"], "bound_by": b8["bound_by"],
            "library_ms": b8["library_ms"],
            # the training path: one f32 step at B=20, (C,) and (B, C) affines
            "train_step_ms": in_fwd["ms"],
            "train_step_sample_affine_ms": in_fwd["sample_affine_ms"],
            # the AdaIN path: adain at relu4_1, (8, 32, 32, 512) f32, (B, C) affine
            "adain_ms": adain["kernel_times"]["float32"]["in_fwd"]["ms"],
            "adain_max_abs_err": err["adain_in"],
            # the int8 path: 14 sites a forward, f32, (C,) affines, ReLU fused
            # (launches over its card-vs-CPU runs: dynamic and static, B=1, 8)
            "launches_int8": sum(int8["launches"]),
            "int8_max_abs_err": int8["in_max_abs_err"],
            **{f"int8_in_{k}_ms": {n: int8["times"][n]["stages_ms"][key] for n in INT8_BATCHES}
               for k, key in (("kernel", "in_kernel"), ("bound", "in_kernel_bound_ms"),
                              ("plain", "in_kernel_plain_ms"),
                              ("library", "in_kernel_library_ms"))},
            # the ONNX runtime: 14 InstanceNormalization nodes a forward, f32,
            # relu=False (forwards at 256x256 and 200x300)
            "launches_onnx_runtime": sum(exported["launches"]),
            "onnx_runtime_max_abs_err": exported["in_max_abs_err"],
        }, {
            # the video path's capture mode: 14 sites of a 256x256 bf16 forward at B=8
            "name": "instance_norm_fwd_capture",
            "route": "cuda",
            "source": src + "instance_norm.cu",
            "replaces": "fast_neural_style_transfer_tpu/ops/pallas_norm.py:61",
            "launches": video["counts"]["by_mode"]["capture"],
            "max_abs_err": err["in_stats"]["capture"],
            "ms": vk["capture_ms"], "plain_ms": vk["capture_plain_ms"],
            "bound_ms": vk["bound_ms"], "bound_by": vk["bound_by"],
            "library_ms": None, "plain_kernel_ms": vk["plain_kernel_ms"],
        }, {
            # the video path's inject mode (blend 1, a (1, C) reference), per
            # forward as above; blend 0.5 beside it
            "name": "instance_norm_fwd_inject",
            "route": "cuda",
            "source": src + "instance_norm.cu",
            "replaces": "fast_neural_style_transfer_tpu/ops/pallas_norm.py:61",
            "launches": video["counts"]["by_mode"]["inject"],
            "max_abs_err": err["in_stats"]["inject"],
            "ms": vk["inject_ms"], "plain_ms": vk["inject_plain_ms"],
            "bound_ms": vk["bound_ms"], "bound_by": vk["bound_by"],
            "library_ms": vk["inject_library_ms"],
            "blend_ms": vk["inject_blend_ms"], "blend_plain_ms": vk["inject_blend_plain_ms"],
        }, {
            "name": "instance_norm_bwd",
            "route": "cuda",
            "source": src + "instance_norm.cu",
            "replaces": "fast_neural_style_transfer_tpu/ops/pallas_norm.py:115",
            "launches": trained["launches"]["instance_norm_bwd"],
            "launches_by_route": trained["bwd_by_route"],
            "launches_multi_style": multi["counts"]["instance_norm_bwd"],
            "max_abs_err": max(err["in_bwd"], err["affine_bwd"]),
            # the training path: the 14 sites of one f32 step at B=20, 256x256
            "ms": in_bwd["ms"], "sample_affine_ms": in_bwd["sample_affine_ms"],
            "plain_ms": in_bwd["plain_ms"],
            "bound_ms": in_bwd["bound_ms"], "bound_by": in_bwd["bound_by"],
            "library_ms": in_bwd["library_ms"],
        }, {
            "name": "conv2d_same_bwd",
            "route": "cuda",
            "source": src + "conv_same_bwd.cu",
            "replaces": "fast_neural_style_transfer_tpu/ops/pallas_conv.py:87",
            "launches": trained["launches"]["conv2d_same_dx"],
            "launches_by_route": trained["conv_by_route"],
            "max_abs_err": max(err["conv"].values()),
            # the training path: VGG conv1_1 dx of one f32 step at B=20, 256x256
            "ms": conv["ms"], "tiled_ms": conv["tiled_ms"], "plain_ms": conv["plain_ms"],
            "bound_ms": conv["bound_ms"], "bound_by": conv["bound_by"],
            "library_ms": conv["library_ms"],
            # the AdaIN training path: conv1_1 dx of one f32 step at B=8, 256x256
            "launches_adain": adain["counts"]["conv2d_same_dx"]["launches"],
            "adain_max_abs_err": err["conv"][ADAIN_BATCH, 256, 256, 3, 3],
            "adain_ms": adain["kernel_times"]["float32"]["conv_dx"]["ms"],
            "adain_plain_ms": adain["kernel_times"]["float32"]["conv_dx"]["plain_ms"],
            "adain_bound_ms": adain["kernel_times"]["float32"]["conv_dx"]["bound_ms"],
            "adain_library_ms": adain["kernel_times"]["float32"]["conv_dx"]["library_ms"],
        }]
        def by_mode(counts, fn, mode):
            """A mode's launches summed over the ranks of a spatial run."""
            return sum(c.get(fn, {}).get("launches_by_mode", {}).get(mode, 0)
                       for c in counts)

        sc, tc, ac = spatial["counts"], spatial_train["counts"], spatial_adain["counts"]
        st, sb = stimes["float32"], stimes["bfloat16"]
        sharded = {"route": "cuda", "source": src + "instance_norm.cu"}
        for mode, name in (("stats", "instance_norm_fwd_stats"),
                           ("sharded_apply", "instance_norm_fwd_sharded_apply")):
            kernels.append({
                "name": name, **sharded,
                "replaces": "fast_neural_style_transfer_tpu/ops/pallas_norm.py:61",
                # the spatial inference CLI (two ranks), then the training CLI
                # and the AdaIN CLI
                "launches": by_mode(sc, "instance_norm_fwd", mode),
                "launches_spatial_train": by_mode(tc, "instance_norm_fwd", mode),
                "launches_spatial_adain": by_mode(ac, "instance_norm_fwd", mode),
                "max_abs_err": err["sharded"][mode],
                # one rank's share (of two) of a 2160x3840 f32 forward's sites
                **{k: st[mode][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                            "library_ms")},
                "bf16": sb[mode],
            })
        kernels.append({
            "name": "instance_norm_bwd_sharded", **sharded,
            "replaces": "fast_neural_style_transfer_tpu/ops/pallas_norm.py:115",
            "launches": (by_mode(tc, "instance_norm_bwd", "bwd_sums")
                         + by_mode(tc, "instance_norm_bwd", "bwd_apply")),
            "launches_by_mode": {m: by_mode(tc, "instance_norm_bwd", m)
                                 for m in ("bwd_sums", "bwd_apply")},
            "max_abs_err": max(err["sharded"]["bwd_sums"], err["sharded"]["bwd_apply"]),
            # one rank's share (of two) of a 512x512 B=2 f32 step's 14 sites:
            # both passes; the library time is autograd's whole IN backward
            **{k: st["bwd_sums"][k] + st["bwd_apply"][k]
               for k in ("ms", "plain_ms", "bound_ms")},
            "bound_by": st["bwd_apply"]["bound_by"],
            "library_ms": st["bwd_sums"]["library_ms"],
            "sums_ms": st["bwd_sums"]["ms"], "apply_ms": st["bwd_apply"]["ms"],
            "bf16": {"sums": sb["bwd_sums"], "apply": sb["bwd_apply"]},
        })
        # each rank's launches on the data-parallel paths: the training loop
        # (data 2 x space 1), the AdaIN step, and the 2-D step (data 2 x space 2)
        def per_rank(counts, fn, mode=None):
            return [c.get(fn, {}).get("launches_by_mode", {}).get(mode, 0) if mode
                    else c.get(fn, {}).get("launches", 0) for c in counts]

        dpc, dac, dsc = dparallel["counts"], dparallel["adain_counts"], dspace["counts"]
        data_parallel = {
            "instance_norm_fwd": per_rank(dpc, "instance_norm_fwd", "plain"),
            "instance_norm_fwd_capture": per_rank(dpc, "instance_norm_fwd", "capture"),
            "instance_norm_fwd_inject": per_rank(dpc, "instance_norm_fwd", "inject"),
            "instance_norm_bwd": per_rank(dpc, "instance_norm_bwd", "plain"),
            "conv2d_same_bwd": per_rank(dpc, "conv2d_same_dx"),
            "instance_norm_fwd_stats": per_rank(dsc, "instance_norm_fwd", "stats"),
            "instance_norm_fwd_sharded_apply": per_rank(dsc, "instance_norm_fwd",
                                                        "sharded_apply"),
            "instance_norm_bwd_sharded": [
                a + b for a, b in zip(per_rank(dsc, "instance_norm_bwd", "bwd_sums"),
                                      per_rank(dsc, "instance_norm_bwd", "bwd_apply"))],
        }
        for k in kernels:
            k["launches_data_parallel"] = data_parallel[k["name"]]
        kernels[0]["launches_data_parallel_adain"] = per_rank(dac, "instance_norm_fwd")
        kernels[0]["launches_data_parallel_serving"] = dserve["main_launches"]
        kernels[4]["launches_data_parallel_adain"] = per_rank(dac, "conv2d_same_dx")
        # row 16's paths: the f32-transport step, fnst-parity (a child), the
        # preemption drill's two children, the quickstart example (a child)
        for k, fn in ((0, "instance_norm_fwd"), (3, "instance_norm_bwd"),
                      (4, "conv2d_same_dx")):
            kernels[k]["launches_tooling"] = {
                path: tooling[path].get(fn, 0)
                for path in ("pipeline", "parity", "drill", "quickstart")}
        kernels.append({
            "name": "reflect_pad",
            "route": "cuda",
            "source": src + "reflect_pad.cu",
            "replaces": None,  # jnp.pad, lowered by XLA
            # the serving phase's forwards (13 a forward); conv1's pad of
            # the image batch in each training step; the video CLI's
            # forwards; the AdaIN training steps (the decoder's first pad)
            # and the AdaIN stylizer's forwards (9 each); the int8 path
            # (none: its convs gather their own codes) and its calibration
            "launches": served["pad_launches"],
            "launches_training": trained["launches"]["reflect_pad"],
            "launches_video": video["counts"]["reflect_pad"],
            "launches_adain": {"training": adain["counts"]["reflect_pad"]["launches"],
                               "stylizer": sum(adain["stylizer_pad_launches"])},
            "launches_int8": {"forwards": sum(int8["pad_launches"]),
                              "calibrate": int8["calibrate_pad_launches"]},
            # against the plain version and the replaced route at every
            # serving pad site (phase_reflect_pad)
            "max_abs_err": pads["max_abs_err"],
            # B=8 bf16 at PAD_TIMED: the kernel, its bound, the plain version,
            # the route it replaced and F.pad(...).contiguous
            **{k: [t[k] for t in pads["times"]]
               for k in ("ms", "bound_ms", "plain_ms", "replaced_ms", "library_ms")},
            "bound_by": "bytes",
        })
        kernels.append({
            "name": "moment_attention",
            "route": "cuda",
            "source": src + "moment_attention.cu",
            "replaces": None,  # the JAX package has no AdaAttN
            # a bf16 AttentionalStylizer's batches through MicroBatcher (3 each)
            "launches": moments["serving"]["launches"],
            "batches": moments["serving"]["batches"],
            "max_abs_err": moments["max_abs_err"],
            # B=8 at the three sites of a 512^2 forward: the kernel, its bound,
            # the plain version (float32) and the bf16 bmm composition
            **{k: [t[k] for t in moments["times"]]
               for k in ("ms", "bound_ms", "plain_ms", "library_ms")},
            "bound_by": [t["bound_by"] for t in moments["times"]],
        })
        kernels.append({
            "name": "conv_to_rgb",
            "route": "cuda",
            "source": src + "conv_to_rgb.cu",
            "replaces": None,  # XLA's conv (the JAX package's reflect_conv2d)
            # the serving phase's bf16 forwards (1 each), then the phase's
            # eager and replayed forwards
            "launches": served["rgb_launches"],
            "launches_phase": rgbs["serving"],
            "max_abs_err": rgbs["max_abs_err"],
            # B=8 512^2 and B=1 256^2: the kernel, its bound, the plain
            # version (float32) and cuDNN's bf16 F.conv2d
            **{k: [t[k] for t in rgbs["times"]]
               for k in ("ms", "bound_ms", "plain_ms", "library_ms")},
            "bound_by": [t["bound_by"] for t in rgbs["times"]],
        })
        print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                             "count": dev["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
