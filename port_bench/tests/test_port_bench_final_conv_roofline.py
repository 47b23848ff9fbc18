"""``final_conv_roofline.closed`` on synthetic traces: the reading from known
kernel times and batch shapes, None where the kernels' count differs from
the forwards or no kernel ran, and the bytes counted before the pad."""

import sys
from importlib import import_module
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

import pytest  # noqa: E402

from counts.peaks import H100, least_seconds  # noqa: E402
from test_port_bench_stytr2 import _kernel, _Run  # noqa: E402

KERNEL = ("void (anonymous namespace)::conv_to_rgb_kernel(__nv_bfloat16 const*, "
          "unsigned short const*, __nv_bfloat16 const*, __nv_bfloat16*, "
          "(anonymous namespace)::Geo)")
CUDNN = ("void cutlass::Kernel<cutlass_tensorop_s1688fprop_optimized_tf32_256x64_16x4_nhwc_"
         "align4>(cutlass_tensorop_s1688fprop_optimized_tf32_256x64_16x4_nhwc_align4::Params)")
FORWARDS = [(1e-3, 1.01e-3, 8, 512, 512), (2e-3, 2.01e-3, 3, 512, 512)]  # host seconds


def _metric():
    return import_module("metrics.final_conv_roofline")


def test_reads_the_least_time_over_the_kernels_time():
    m = _metric()
    kernels = [_kernel(KERNEL, 2e3, 150), _kernel(KERNEL, 4e3, 60),
               _kernel("pad_pixels", 5e3, 90)]
    least = sum(least_seconds(*m.final_conv_cost(n, h, w, 2), "bf16", H100)
                for _, _, n, h, w in FORWARDS)
    assert m.read(_Run(kernels, FORWARDS)) == pytest.approx(100.0 * least / 210e-6)
    # at 512^2 the least time is the bytes': 0.0438 ms a B=8 batch
    assert least_seconds(*m.final_conv_cost(8, 512, 512, 2), "bf16", H100) == pytest.approx(
        4.382e-5, rel=1e-3)


def test_none_without_the_kernel_or_with_another_count():
    m = _metric()
    assert m.read(_Run([_kernel(CUDNN, 2e3, 3000), _kernel(CUDNN, 9e3, 3000)], FORWARDS)) is None
    assert m.read(_Run([_kernel(KERNEL, 2e3, 150)], FORWARDS)) is None
    three = [_kernel(KERNEL, 2e3 + 1e3 * i, 100) for i in range(3)]
    assert m.read(_Run(three, FORWARDS)) is None
    untraced = _Run([_kernel(KERNEL, 2e3, 150)], FORWARDS[:1])
    untraced.trace = None
    assert m.read(untraced) is None


def test_bytes_are_counted_before_the_pad():
    """x at (n, h, w, 32), not (n, h + 8, w + 8, 32); y and the weights once."""
    flops, moved = _metric().final_conv_cost(8, 512, 512, 2)
    assert flops == 2 * 8 * 512 * 512 * 3 * 32 * 81
    assert moved == (8 * 512 * 512 * 32 + 8 * 512 * 512 * 3 + 3 * 32 * 81 + 3) * 2
    assert moved < (8 * 520 * 520 * 32 + 8 * 512 * 512 * 3) * 2
