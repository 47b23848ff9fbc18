"""AdaAttN's benchmark pieces on the CPU: its counts against PyTorch's
``FlopCounterMode`` on the program's forward (the style's own work left
out), the float8 control, its bf16 twin and the four planted faults against
the cell's limit at the published widths on small images, the two new
readers on a synthetic record, and a whole tiny run's last line."""

import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from counts import adaattn as counts  # noqa: E402
from counts.peaks import H100, least_seconds  # noqa: E402
from harness import program_spans, seeded, serving  # noqa: E402
from harness.systems import adaattn as system  # noqa: E402
from reference import adaattn as ref  # noqa: E402
from reference.common import pad_to_bucket  # noqa: E402
from test_port_bench_stytr2 import _kernel, _Run, _stage  # noqa: E402

CPU = torch.device("cpu")
CELL = "adaattn.serve.512-closed"
SAMPLE = 60  # relu3_1's max_sample on the CPU: a 64² style has 256 positions there


def _limits() -> dict:
    return json.loads((BENCH / "workloads" / f"{CELL}.json").read_text())["limits"]


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


@pytest.fixture(scope="module")
def published(monkeypatch_module):
    """Seeded weights at the published widths, with a 64² style (a 512²
    style's encoding is too large a job for the CPU tests) sampled to 60
    positions at relu3_1, and four content images of sides 40-64."""
    from fast_neural_style_transfer_tpu_torch.models import adaattn as model

    monkeypatch_module.setattr(system, "STYLE_SIDE", 64)
    monkeypatch_module.setitem(model.MAX_SAMPLE, 2, SAMPLE)
    monkeypatch_module.setattr(ref, "SITES", ((ref.SITES[0][0], 2, SAMPLE),) + ref.SITES[1:])
    weights = system.make_weights(2 ** 31 + 5, CPU)
    rng = np.random.default_rng(5)
    imgs = [im[:h, :w] for im, h, w in zip(seeded.images(4, 64, 64, 6, CPU),
                                           rng.integers(40, 65, 4), rng.integers(40, 65, 4))]
    return weights, imgs


def test_forward_flops_match_flop_counter_with_the_style_left_out(published, monkeypatch):
    from fast_neural_style_transfer_tpu_torch.infer.adaattn import AttentionalStylizer

    weights, _ = published
    monkeypatch.setattr(counts, "SITES", ((2, 4, SAMPLE),) + counts.SITES[1:])
    sty = AttentionalStylizer(weights["model"], weights["vgg"], device="cpu")
    sty.set_style(torch.rand(1, 64, 48, 3))
    x = torch.rand(2, 64, 96, 3)
    with torch.inference_mode(), FlopCounterMode(display=False) as fc:
        sty.forward_net(x)
    shapes = counts.site_shapes(64, 96, (64, 48))
    assert [s[1] for s in shapes] == [SAMPLE, 48, 12]
    assert fc.get_total_flops() == 2 * counts.forward_flops(64, 96, style_hw=(64, 48))
    flops, _ = counts.attention_cost(2, 64, 96, 2, style_hw=(64, 48))
    assert flops == 2 * sum(counts.attention_flops(*s) for s in shapes)


def test_counts_at_the_published_widths():
    """Per 512² content image with the 512² style cached: VGG19 to relu5_1
    189.3 GFLOP, the attentions 200.7, the queries 18.6, the merge 19.3, the
    decoder 145.9."""
    att = sum(counts.attention_flops(*s) for s in counts.site_shapes(512, 512))
    assert counts.site_shapes(512, 512) == [(16384, 4096, 448, 256), (4096, 4096, 960, 512),
                                            (1024, 1024, 1472, 512)]
    assert abs(att / 1e9 - 200.66) < 0.01
    assert abs(counts.forward_flops(512, 512) / 1e9 - 573.76) < 0.01
    flops, bytes_moved = counts.attention_cost(8, 512, 512, 2)
    assert flops == 8 * att
    assert least_seconds(flops, bytes_moved, "bf16", H100) == flops / H100["flops"]["bf16"]


def test_in_fwd_cost_counts_the_key_builders_instance_norms(published, monkeypatch):
    """``in_fwd_cost`` (read by ``instance_norm_fwd_roofline.closed``) covers
    exactly the elements of the 12 instance norms a content batch's keys
    take, one read and one write each."""
    from fast_neural_style_transfer_tpu_torch.infer.adaattn import AttentionalStylizer
    from fast_neural_style_transfer_tpu_torch.models import adaattn as model

    weights, _ = published
    sty = AttentionalStylizer(weights["model"], weights["vgg"], device="cpu")
    sty.set_style(torch.rand(1, 64, 48, 3))
    seen = []
    inner = model.instance_norm

    def recorded(x, *args, **kw):
        seen.append(x.numel())
        return inner(x, *args, **kw)

    monkeypatch.setattr(model, "instance_norm", recorded)
    with torch.inference_mode():
        sty.forward_net(torch.rand(2, 64, 96, 3))
    flops, bytes_moved = counts.in_fwd_cost(2, 64, 96, 2)
    assert len(seen) == 12
    assert bytes_moved == 2 * sum(seen) * 2
    assert flops == counts.IN_FLOPS_PER_ELEMENT * sum(seen)


def _gaps(weights, imgs, outs) -> dict:
    return serving.compare_u8(outs, system.reference_u8(weights, imgs, 64, CPU))


def _fails(gaps: dict) -> bool:
    return any(gaps[k] > v for k, v in _limits().items())


def test_the_output_spans_the_u8_range(published):
    weights, imgs = published
    outs = system.reference_u8(weights, imgs, 64, CPU)
    flat = np.concatenate([o.ravel() for o in outs])
    assert flat.std() > 20 and np.isin(flat, (0, 255)).mean() < 0.2


def test_the_program_passes_and_the_float8_control_fails(published):
    weights, imgs = published
    batch = np.stack([pad_to_bucket(im, 64) for im in imgs])

    def crop(y):
        return [yi[:im.shape[0], :im.shape[1]] for yi, im in zip(y, imgs)]

    config = {"precision": "f32"}
    program = system.serve_forward(config, weights, {"bucket_multiple": 64}, CPU, "program")
    assert not _fails(_gaps(weights, imgs, crop(program(batch))))
    control = system.serve_forward(config, weights, {"bucket_multiple": 64}, CPU, "control")
    gaps = _gaps(weights, imgs, crop(control(batch)))
    assert _fails(gaps), gaps
    # the control's emulation one precision up, every tensor stored in bf16,
    # passes as the bf16 program does
    twin = system.reference_forward(weights, CPU, stored=torch.bfloat16)
    assert not _fails(_gaps(weights, imgs, crop(twin(batch))))


@pytest.mark.parametrize("fault", ref.FAULTS)
def test_each_planted_fault_fails(published, fault):
    weights, imgs = published
    outs = system.reference_u8(weights, imgs, 64, CPU, fault=fault)
    gaps = _gaps(weights, imgs, outs)
    assert _fails(gaps), (fault, gaps)


KERNEL = ("void (anonymous namespace)::moment_attention_kernel<128, 3>(__nv_bfloat16 const*, "
          "__nv_bfloat16 const*, __nv_bfloat16 const*, float const*, __nv_bfloat16 const*, "
          "__nv_bfloat16*, int, int, int, int, int)")


def test_moment_attention_roofline_reads_the_kernel_against_the_counter(monkeypatch):
    from importlib import import_module

    read = import_module("metrics.moment_attention_roofline").read
    forwards = [(1e-3, 1.01e-3, 8, 512, 512)]  # host seconds, as the runner's
    kernels = [_kernel(KERNEL, 2e3 + 100 * i, 90) for i in range(3)]
    spans = [_stage("adaattn.attend", 2e3, 1.0, ops=3),
             _stage("adaattn.attend", 2e6, 1.0, ops=3)]  # outside the window
    monkeypatch.setattr(program_spans, "buffer", lambda: spans)
    run = _Run(kernels, forwards)
    run.counts = counts
    least = least_seconds(*counts.attention_cost(8, 512, 512, 2), "bf16", H100)
    assert read(run) == pytest.approx(100.0 * least / (3 * 90e-6))
    # a kernel the counter did not count
    short = _Run(kernels[:2], forwards)
    short.counts = counts
    assert read(short) is None
    monkeypatch.setattr(program_spans, "buffer", lambda: [])
    assert read(run) is None


def test_adaattn_device_pct_reads_the_stage_spans(monkeypatch):
    from importlib import import_module

    read = import_module("metrics.adaattn_device_pct").read
    spans = [_stage("adaattn.encode", 2e3, 2.0), _stage("adaattn.keys", 3e3, 0.5),
             _stage("adaattn.attend", 6e3, 4.5), _stage("adaattn.decode", 1e4, 3.0),
             _stage("adaattn.decode", 2e6, 50.0)]  # outside the window
    monkeypatch.setattr(program_spans, "buffer", lambda: spans)
    run = _Run([], [(1e-3, 1.01e-3, 8, 512, 512)])
    assert read(run) == pytest.approx(100.0 * 5.0 / 10.0)
    monkeypatch.setattr(program_spans, "buffer", lambda: [])
    assert read(run) is None


@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_run_last_line(capsys, monkeypatch, trace):
    import run
    from test_port_bench_run import tiny

    monkeypatch.setattr(system, "STYLE_SIDE", 64)
    rc = run.main(["--workload", CELL, "--seed", str(2 ** 31 + 91), "--seconds", "0.7",
                   "--trace", str(trace)], device=CPU, cell=tiny(CELL))
    assert rc == 0
    r = json.loads(capsys.readouterr()[0].strip().splitlines()[-1])
    assert r["correct"] is True and r["failed"] == 0
    if trace:  # no peaks on the CPU: the roofline and the MFU read nothing
        assert "adaattn_device_pct.closed" in r["metrics"]
        assert "moment_attention_roofline.closed" not in r["metrics"]
    else:
        assert {"serve_img_per_s", "setup_s"} <= set(r["metrics"])
