"""StyTr²'s benchmark pieces on the CPU: its counts against PyTorch's
``FlopCounterMode`` on a small model (the style's own work left out), the
float8 control, its bf16 twin and the three planted faults against the
cell's limit at the published widths on small images, the two new readers
on a synthetic record, and a whole tiny run's last line."""

import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from counts import stytr2 as counts  # noqa: E402
from counts.peaks import H100, least_seconds  # noqa: E402
from harness import program_spans, seeded, serving  # noqa: E402
from harness.systems import stytr2 as system  # noqa: E402
from harness.trace import Trace  # noqa: E402
from reference import stytr2 as ref  # noqa: E402
from reference.common import pad_to_bucket  # noqa: E402

CPU = torch.device("cpu")
CELL = "stytr2.serve.512-closed"
SMALL = dict(dim_feedforward=128, num_encoder_layers=1, num_decoder_layers=1)


def _limits() -> dict:
    return json.loads((BENCH / "workloads" / f"{CELL}.json").read_text())["limits"]


def _small_stylizer(style_hw):
    from fast_neural_style_transfer_tpu_torch.infer.stytr2 import TransformerStylizer
    from fast_neural_style_transfer_tpu_torch.models.stytr2 import StyTr2

    torch.manual_seed(0)
    sty = TransformerStylizer(StyTr2(**SMALL).state_dict(), device="cpu")
    return sty.set_style(torch.rand(1, *style_hw, 3))


def test_forward_flops_match_flop_counter_with_the_style_left_out():
    sty = _small_stylizer((32, 40))
    x = torch.rand(2, 64, 48, 3)
    with torch.inference_mode(), FlopCounterMode(display=False) as fc:
        sty.forward_unit(x)
    want = counts.forward_flops(64, 48, style_tokens=4 * 5, ffn=128, layers=1)
    assert fc.get_total_flops() == 2 * want
    # the attentions alone are the batched products (linears are addmm/mm)
    bmm = fc.get_flop_counts()["Global"][torch.ops.aten.bmm]
    assert bmm == counts.attention_cost(2, 64, 48, 4, style_tokens=20, layers=1)[0]


def test_counts_at_the_published_widths():
    """Per 512² content image with the 512² style cached: 309 GFLOP of
    attention, 155 of projections and FFNs, 126.6 of the AdaIN decoder."""
    att = 9 * counts.attention_flops(4096, 4096)
    assert abs(att / 1e9 - 309.24) < 0.01
    assert abs(counts.forward_flops(512, 512) / 1e9 - 591.37) < 0.01
    assert abs((counts.transformer_flops(512, 512) - att) / 1e9 - 155.6) < 0.1
    flops, bytes_moved = counts.attention_cost(8, 512, 512, 2)
    assert flops == 8 * att
    # compute-bound by three orders: the least time is the operations'
    assert least_seconds(flops, bytes_moved, "bf16", H100) == flops / H100["flops"]["bf16"]


def _gaps(weights, imgs, outs) -> dict:
    return serving.compare_u8(outs, system.reference_u8(weights, imgs, 64, CPU))


@pytest.fixture(scope="module")
def published(monkeypatch_module):
    """Seeded weights at the published widths, with a 64² style (a 512²
    style's encoding is too large a job for the CPU tests), and four
    content images of sides 40-64."""
    monkeypatch_module.setattr(system, "STYLE_SIDE", 64)
    weights = system.make_weights(2 ** 31 + 5, CPU)
    rng = np.random.default_rng(5)
    imgs = [im[:h, :w] for im, h, w in zip(seeded.images(4, 64, 64, 6, CPU),
                                           rng.integers(40, 65, 4), rng.integers(40, 65, 4))]
    return weights, imgs


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


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

    program = system.serve_forward({"precision": "f32"}, weights, {"bucket_multiple": 64}, CPU,
                                   "program")
    assert not _fails(_gaps(weights, imgs, crop(program(batch))))
    control = system.serve_forward({"precision": "bf16"}, weights, {"bucket_multiple": 64}, CPU,
                                   "control")
    gaps = _gaps(weights, imgs, crop(control(batch)))
    assert _fails(gaps), gaps
    # the control's emulation one precision up, every tensor stored in bf16,
    # passes as the bf16 program does
    twin = system.reference_forward(weights, CPU, stored=torch.bfloat16)
    assert not _fails(_gaps(weights, imgs, crop(twin(batch))))


def test_rounded_stores_a_tensor_in_float8_with_one_scale():
    t = torch.tensor([[-3.0, 0.1], [0.3, 1000.0]])
    r = system.rounded(t, system.LOWER)
    assert r.dtype == torch.float32 and r[1, 1] == 1000.0  # the largest maps to e4m3's 448
    grid = (t * (448.0 / 1000.0)).to(torch.float8_e4m3fn).float() * (1000.0 / 448.0)
    torch.testing.assert_close(r, grid, rtol=1e-6, atol=0)
    assert torch.equal(system.rounded(t, torch.bfloat16), t.to(torch.bfloat16).float())
    assert torch.equal(system.rounded(torch.zeros(3), system.LOWER), torch.zeros(3))


def test_stored_in_rounds_every_floating_result_only():
    x = torch.tensor([1.0, 1.0 + 2 ** -10])
    with system.StoredIn(torch.bfloat16):
        y = x * 1.0
        i = torch.argmax(x)
    assert torch.equal(y, torch.tensor([1.0, 1.0])) and i.dtype == torch.int64


@pytest.mark.parametrize("fault", ref.FAULTS)
def test_each_planted_fault_fails(published, fault):
    weights, imgs = published
    outs = system.reference_u8(weights, imgs, 64, CPU, fault=fault)
    gaps = _gaps(weights, imgs, outs)
    assert _fails(gaps), (fault, gaps)


class _Run:
    """A traced serving record: a window, forwards and the program's spans
    on one clock (microseconds; the host clock's offset 0)."""

    def __init__(self, events, forwards, config=None):
        self.trace = Trace([{"ph": "X", "cat": "user_annotation", "name": "window", "ts": 0,
                             "dur": 1e6},
                            {"ph": "X", "cat": "user_annotation", "name": "forward", "ts": 1e3,
                             "dur": 10}] + events)
        self.forwards = forwards
        self.peaks, self.counts = H100, counts
        self.config = config or {"precision": "bf16"}


def _kernel(name, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur}


def _stage(name, start_us, ms, ops=None):
    from fast_neural_style_transfer_tpu_torch.utils import tracing

    attrs = {} if ops is None else {"ops": ops}
    return tracing.Span(name, 0, None, 0, int(start_us * 1e3), int(start_us * 1e3 + ms * 1e6),
                        attrs, tracing.HOST)


FLASH = ("void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits<64, 128>, false>"
         "(Flash_fwd_params)")


def test_attention_roofline_reads_the_flash_kernels_against_the_counter(monkeypatch):
    from importlib import import_module

    read = import_module("metrics.attention_roofline").read
    forwards = [(1e-3, 1.01e-3, 8, 512, 512)]  # host seconds, as the runner's
    kernels = [_kernel(FLASH, 2e3 + 10 * i, 8) for i in range(9)]
    spans = [_stage("stytr2.encode", 2e3, 1.0, ops=3), _stage("stytr2.decode", 3e3, 1.0, ops=6),
             _stage("stytr2.encode", 2e6, 1.0, ops=3)]  # outside the window
    monkeypatch.setattr(program_spans, "buffer", lambda: spans)
    run = _Run(kernels, forwards)
    least = least_seconds(*counts.attention_cost(8, 512, 512, 2), "bf16", H100)
    assert read(run) == pytest.approx(100.0 * least / (9 * 8e-6))
    # a kernel the counter did not count (or a backend the pattern misses)
    assert read(_Run(kernels[:8], forwards)) is None
    monkeypatch.setattr(program_spans, "buffer", lambda: spans[:1])
    assert read(run) is None


def test_transformer_device_pct_reads_the_stage_spans(monkeypatch):
    from importlib import import_module

    read = import_module("metrics.transformer_device_pct").read
    spans = [_stage("stytr2.embed", 2e3, 0.5), _stage("stytr2.encode", 3e3, 2.0),
             _stage("stytr2.decode", 6e3, 3.5), _stage("stytr2.cnn", 1e4, 4.0),
             _stage("stytr2.cnn", 2e6, 50.0)]  # outside the window
    monkeypatch.setattr(program_spans, "buffer", lambda: spans)
    run = _Run([], [(1e-3, 1.01e-3, 8, 512, 512)])
    assert read(run) == pytest.approx(100.0 * 6.0 / 10.0)
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
    if trace:  # no peaks on the CPU: the roofline reads nothing
        assert "transformer_device_pct.closed" in r["metrics"]
        assert "attention_roofline.closed" not in r["metrics"]
    else:
        assert {"serve_img_per_s", "setup_s"} <= set(r["metrics"])
