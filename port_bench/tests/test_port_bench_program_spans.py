"""The readers of the program's own spans and counters, on a synthetic
trace and record: the serving runner's offset placing the program's buffer
on the trace's clock, the training loop's native spans, the device-idle
time inside spans, and every new reader reading None where the program
recorded nothing (a program without the recorder, as at an older commit)."""

import sys
from pathlib import Path
from types import SimpleNamespace

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

import pytest  # noqa: E402

from fast_neural_style_transfer_tpu_torch.utils import tracing  # noqa: E402
from harness import program_spans, spec  # noqa: E402
from harness.trace import Trace  # noqa: E402

ENTRIES = ["batcher_host_ms.closed", "linger_ms.serve", "enqueue_wait_p95_ms.serve",
           "copy_in_ms.closed", "copy_in_ms.serve", "idle_in_launch_pct.closed",
           "idle_in_launch_pct.serve", "idle_in_launch_pct.train", "idle_in_update_pct.train",
           "sync_wait_pct.train", "idle_in_pad_stack_pct.closed", "idle_in_copy_out_pct.closed",
           "idle_covered_pct.closed", "idle_covered_pct.train"]
ENTERED_S = 100.0  # the host clock just inside the window, seconds
W0, W1 = 1000.0, 2000.0  # the window on the trace's clock, microseconds


@pytest.fixture(autouse=True)
def _fresh_buffer():
    tracing.clear()
    yield
    tracing.clear()


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def _ns(trace_us):
    """A host-clock ``perf_counter_ns`` that the serving offset maps to
    ``trace_us``."""
    return round((trace_us - W0) * 1e3 + ENTERED_S * 1e9)


def _serving_run(stats=None):
    kernels = [_ev("k", "kernel", 1100, 100), _ev("k", "gpu_memcpy", 1500, 200)]
    trace = Trace([_ev("window", "user_annotation", W0, W1 - W0)] + kernels)
    forwards = [(ENTERED_S + 50e-6, ENTERED_S + 800e-6, 8, 512, 512)]
    trace.add_host_spans("forward", [f[:2] for f in forwards], ENTERED_S)
    return SimpleNamespace(trace=trace, forwards=forwards, stats=stats or {})


def _training_run(steps=None):
    spans = [("train.loss", 1000, 300), ("train.grad", 1300, 300), ("train.sync", 1600, 100),
             ("train.update", 1700, 200)]
    kernels = [_ev("k", "kernel", 1000, 150), _ev("k", "kernel", 1350, 400),
               _ev("k", "kernel", 1800, 50)]
    trace = Trace([_ev("window", "user_annotation", W0, W1 - W0)]
                  + [_ev(n, "user_annotation", s, d) for n, s, d in spans] + kernels)
    return SimpleNamespace(trace=trace, stats={}, steps=steps or [])


def _read(name, run):
    return spec.load_reader(name)(run)


def test_every_new_entry_has_a_reader_and_a_list_of_accepted_cells():
    bench = spec._load_json(spec.ROOT / "BENCHMARK.json")
    cells = {w["name"] for w in bench["workloads"]}
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in ENTRIES:
        assert callable(spec.load_reader(name))
        assert entries[name]["workloads"] and set(entries[name]["workloads"]) <= cells


def test_serving_offset_maps_the_buffer_onto_the_runners_forward_spans():
    run = _serving_run()
    at = program_spans.serving_offset(run)
    assert at == pytest.approx(W0 - ENTERED_S * 1e6)
    tracing.record("batcher.forward", _ns(1050), _ns(1800), batch=0, n=8)
    (got,) = program_spans.intervals(run, "batcher.forward")
    assert got == pytest.approx(run.trace.spans["forward"][0], abs=1e-3)


def test_intervals_clip_to_the_window_and_drop_spans_outside_it():
    run = _serving_run()
    tracing.record("batcher.queued", _ns(-5e6), _ns(-4e6))  # an earlier run's
    tracing.record("batcher.queued", _ns(900), _ns(1200))
    tracing.record("batcher.queued", _ns(1900), _ns(2500))
    assert program_spans.intervals(run, "batcher.queued") == pytest.approx(
        [(1000, 1200), (1900, 2000)], abs=1e-3)
    assert program_spans.intervals(run, "batcher.linger") is None


def test_native_spans_are_read_from_the_trace():
    run = _training_run()
    tracing.record("train.loss", _ns(0), _ns(10))  # ignored: the trace has them
    assert program_spans.intervals(run, "train.loss") == [(1000, 1300)]
    assert program_spans.serving_offset(run) is None


def test_training_offset_maps_the_buffer_onto_the_runners_input_wait_span():
    run = _training_run(steps=[(ENTERED_S, ENTERED_S + 0.5, 20)])
    run.trace.spans["input_wait"].append((W0 + 20, W0 + 30))
    assert program_spans.training_offset(run) == pytest.approx(W0 + 20 - ENTERED_S * 1e6)
    assert program_spans.training_offset(_serving_run()) is None
    assert program_spans.serving_offset(run) is None


def test_roots_merge_the_outermost_spans_but_a_requests_wait():
    run = _serving_run()
    tracing.record("batcher.queued", _ns(1000), _ns(1900), req=0)  # not a phase
    tracing.record("batcher.pad_stack", _ns(1010), _ns(1050))
    tracing.record("batcher.deliver", _ns(1800), _ns(1820))
    tracing.record("batcher.linger", _ns(1820), _ns(1830))  # touches deliver: merged
    with_parent = tracing.Span("stylize.copy_out", 99, 7, 0, _ns(1900), _ns(1950), {})
    tracing._BUFFER.append(with_parent)  # a child: inside its parent, not a root
    assert program_spans.roots(run) == pytest.approx([(1010, 1050), (1800, 1830)], abs=1e-3)
    assert program_spans.roots(SimpleNamespace(trace=None)) is None


def test_idle_inside_spans():
    run = _training_run()
    # train.grad 1300-1600 holds the kernel 1350-1600 of 1350-1750
    assert program_spans.idle_within_s(run, [(1300, 1600)]) == pytest.approx(50e-6)
    # train.loss 1000-1300 holds the kernel 1000-1150
    both = program_spans.intervals(run, "train.loss") + program_spans.intervals(run, "train.grad")
    assert program_spans.idle_within_s(run, both) == pytest.approx(200e-6)


def test_serving_readers():
    stats = {"mean_pad_stack_ms": 2.5, "mean_deliver_ms": 0.75, "mean_linger_ms": 4.0}
    run = _serving_run(stats)
    for start, end in ((1050, 1100), (1700, 1730)):
        tracing.record("stylize.copy_in", _ns(start), _ns(end))
    tracing.record("stylize.launch", _ns(1100), _ns(1300))  # device busy 1100-1200
    tracing.record("stylize.launch", _ns(1400), _ns(1600))  # busy 1500-1600
    for k in range(20):
        tracing.record("batcher.queued", _ns(1001 + k), _ns(1001 + 2 * k), req=k)
    assert _read("batcher_host_ms.closed", run) == pytest.approx(3.25)
    assert _read("linger_ms.serve", run) == pytest.approx(4.0)
    assert _read("copy_in_ms.closed", run) == pytest.approx(0.04, abs=1e-6)
    assert _read("copy_in_ms.serve", run) == _read("copy_in_ms.closed", run)
    assert _read("idle_in_launch_pct.closed", run) == pytest.approx(50.0, abs=1e-6)
    assert _read("enqueue_wait_p95_ms.serve", run) == pytest.approx(18.05e-3, abs=1e-6)


def test_serving_idle_readers():
    # device busy 1100-1200 and 1500-1700 of the window 1000-2000: idle 700 us
    run = _serving_run()
    tracing.record("batcher.pad_stack", _ns(1000), _ns(1150))  # idle 100
    tracing.record("batcher.pad_stack", _ns(1250), _ns(1300))  # idle 50
    tracing.record("stylize.copy_out", _ns(1600), _ns(1800))  # idle 100
    assert _read("idle_in_pad_stack_pct.closed", run) == pytest.approx(15.0)
    assert _read("idle_in_copy_out_pct.closed", run) == pytest.approx(10.0)
    # every span recorded here is a root: 250 us of the 700 idle
    assert _read("idle_covered_pct.closed", run) == pytest.approx(100 * 250 / 700)


def test_training_readers():
    run = _training_run()
    # loss 1000-1300 busy 150, grad 1300-1600 busy 250: idle 200 of 600
    assert _read("idle_in_launch_pct.train", run) == pytest.approx(100 * 200 / 600)
    # update 1700-1900 busy 1700-1750 and 1800-1850: idle 100 of a 1000 window
    assert _read("idle_in_update_pct.train", run) == pytest.approx(10.0)
    assert _read("sync_wait_pct.train", run) == pytest.approx(10.0)


def test_training_coverage_maps_the_buffer_by_the_input_wait_anchor():
    # device busy 1000-1150, 1350-1750, 1800-1850: idle 400 us of the window
    run = _training_run(steps=[(ENTERED_S, ENTERED_S + 0.5, 20)])
    run.trace.spans["input_wait"].append((W0, W0 + 5))
    tracing.record("pipeline.wait", _ns(1000), _ns(1005))
    tracing.record("train.loss", _ns(1005), _ns(1300))  # idle 150
    tracing.record("train.update", _ns(1700), _ns(1900))  # idle 100
    assert _read("idle_covered_pct.train", run) == pytest.approx(100 * 250 / 400)


@pytest.mark.parametrize("name", ENTRIES)
def test_every_reader_reads_none_without_its_spans_or_counters(name, monkeypatch):
    bare = Trace([_ev("window", "user_annotation", W0, W1 - W0),
                  _ev("k", "kernel", 1100, 100)])
    runs = [_serving_run(), SimpleNamespace(trace=bare, stats={}),
            SimpleNamespace(trace=None, stats={}, forwards=[])]
    for run in runs:
        assert _read(name, run) is None
    # a program with no recorder at all, spans or not
    tracing.record("stylize.launch", _ns(1100), _ns(1300))
    tracing.record("batcher.queued", _ns(1100), _ns(1300))
    tracing.record("stylize.copy_in", _ns(1100), _ns(1300))
    monkeypatch.setattr(program_spans, "buffer", lambda: None)
    assert _read(name, _serving_run()) is None


def _pairs_ms(a, b):
    """Both ends' gaps, ms, of two lists of spans paired in order."""
    import numpy as np

    assert len(a) == len(b) and a, (len(a), len(b))
    a, b = np.asarray(sorted(a)), np.asarray(sorted(b))
    return np.abs(a - b).ravel() / 1e3


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["stylenet-ref.serve.512-closed", "stylenet-ref.train.256"])
def test_program_spans_share_the_trace_clock_and_cover_the_idle_time_on_the_card(name):
    """A traced run of the cell, shortened: the buffer's spans, mapped, lie
    on their twins (serving: ``batcher.forward`` on the runner's own
    "forward"; training: ``train.*`` on their native copies), and the
    program's spans hold at least 90 % of the window's device-idle time."""
    import time

    import numpy as np

    device = _card()
    cell = spec.load_cell(name)
    runner = spec.runner(cell.traffic["kind"])
    tracing.clear()
    if cell.traffic["kind"] == "serving":
        run = runner.run(cell, 2 ** 31 + 41, 4.0, device, True, time.perf_counter(), judge=False)
        at = program_spans.serving_offset(run)
        twins = {"batcher.forward": "forward"}
    else:
        run = runner.run(cell, 2 ** 31 + 42, 4.0, device, True, time.perf_counter(),
                         judge_it=False)
        at = program_spans.training_offset(run)
        twins = {n: n for n in ("train.loss", "train.grad", "train.sync", "train.update")}
    for mine, theirs in twins.items():
        buf = [(s.start_ns / 1e3 + at, s.end_ns / 1e3 + at) for s in tracing.spans()
               if s.name == mine]
        gaps = _pairs_ms(buf, run.trace.spans[theirs])
        print(f"{name} {mine}: {gaps.size} ends, median {np.median(gaps):.4f} ms, "
              f"p95 {np.percentile(gaps, 95):.4f}, max {gaps.max():.4f}")
        assert np.median(gaps) <= 0.05 and np.percentile(gaps, 95) <= 0.2, mine
    covered = _read("idle_covered_pct." + ("closed" if "closed" in name else "train"), run)
    print(f"{name}: idle covered {covered:.2f} %")
    assert covered >= 90.0
