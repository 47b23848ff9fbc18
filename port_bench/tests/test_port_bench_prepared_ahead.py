"""The batcher's prepare stage, read by the benchmark: ``prepared_ahead_pct``
(the share of batches the batcher padded and stacked while the dispatcher
was still busy with the one before), ``slot_wait_ms`` (a batch's wait in the
handoff slot) and ``idle_in_pad_outside_forward_pct`` (device-idle time in
the pad and stack outside a running forward). Each reads None where the
program has no such counter or span (an older commit)."""

import sys
import time
from pathlib import Path
from types import SimpleNamespace

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from fast_neural_style_transfer_tpu_torch.serve import MicroBatcher  # noqa: E402
from fast_neural_style_transfer_tpu_torch.utils import tracing  # noqa: E402
from harness import program_spans, spec  # noqa: E402
from harness.trace import Trace  # noqa: E402

CLOSED = ["stylenet-ref.serve.512-closed", "adain-vgg19.serve.512-closed"]
ENTRIES = {"prepared_ahead_pct.closed": (CLOSED, "program_counter"),
           "prepared_ahead_pct.serve": (["stylenet-ref.serve.256-low"], "program_counter"),
           "idle_in_pad_outside_forward_pct.closed": (CLOSED, "device_trace"),
           "slot_wait_ms.serve": (["stylenet-ref.serve.256-low"], "program_counter")}
PREPARED = sorted(n for n in ENTRIES if n.startswith("prepared_ahead_pct"))
ENTERED_S = 100.0  # the host clock just inside the window, seconds
W0, W1 = 1000.0, 2000.0  # the window on the trace's clock, microseconds


@pytest.fixture(autouse=True)
def _fresh_buffer():
    tracing.clear()
    yield
    tracing.clear()


def _ns(trace_us):
    """A host-clock ``perf_counter_ns`` that the serving offset maps to
    ``trace_us``."""
    return round((trace_us - W0) * 1e3 + ENTERED_S * 1e9)


def _serving_run():
    """Device busy 1100-1200 and 1500-1700 of the window 1000-2000."""
    ev = lambda name, cat, ts, dur: {"ph": "X", "name": name, "cat": cat,  # noqa: E731
                                     "ts": ts, "dur": dur}
    trace = Trace([ev("window", "user_annotation", W0, W1 - W0), ev("k", "kernel", 1100, 100),
                   ev("k", "gpu_memcpy", 1500, 200)])
    forwards = [(ENTERED_S + 50e-6, ENTERED_S + 800e-6, 8, 512, 512)]
    trace.add_host_spans("forward", [f[:2] for f in forwards], ENTERED_S)
    return SimpleNamespace(trace=trace, forwards=forwards, stats={})


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_entry_has_the_reader_and_lists_the_cells_that_read_it(name):
    bench = spec._load_json(spec.ROOT / "BENCHMARK.json")
    (entry,) = [m for m in bench["per_layer"] if m["name"] == name]
    cells, source = ENTRIES[name]
    assert entry["workloads"] == cells
    assert entry["layer"] == "batcher" and entry["source"] == source
    assert callable(spec.load_reader(name))
    for cell in cells:
        assert name in {m.name for m in spec.load_cell(cell, bench).per_layer}


@pytest.mark.parametrize("name", PREPARED)
def test_reader_reads_the_counter_as_a_percentage(name):
    read = spec.load_reader(name)
    assert read(SimpleNamespace(stats={"prepared_ahead_share": 0.75})) == pytest.approx(75.0)
    assert read(SimpleNamespace(stats={"prepared_ahead_share": 0.0})) == 0.0


@pytest.mark.parametrize("name", PREPARED)
def test_reader_reads_none_without_the_counter(name):
    read = spec.load_reader(name)
    assert read(SimpleNamespace(stats={"batches": 3, "mean_pad_stack_ms": 2.0})) is None
    assert read(SimpleNamespace(stats={"prepared_ahead_share": None})) is None  # no batch yet


def test_reader_on_the_programs_own_stats():
    def forward(batch):
        time.sleep(0.05)
        return batch

    b = MicroBatcher(forward, max_batch=1, max_wait_ms=0.0)
    try:
        for f in [b.submit(np.zeros((8, 8, 3), np.uint8)) for _ in range(3)]:
            f.result(timeout=60)
        deadline = time.monotonic() + 30
        while b.stats.snapshot()["batches"] < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        stats = b.stats.snapshot()
    finally:
        b.close()
    # the first batch found the dispatcher idle; the other two were stacked
    # while the forward before them slept
    assert spec.load_reader("prepared_ahead_pct.closed")(
        SimpleNamespace(stats=stats)) == pytest.approx(200 / 3)


def test_slot_wait_reads_the_counter_and_none_without_it():
    read = spec.load_reader("slot_wait_ms.serve")
    assert read(SimpleNamespace(stats={"mean_slot_ms": 4.5})) == 4.5
    assert read(SimpleNamespace(stats={"batches": 3, "mean_pad_stack_ms": 2.0})) is None
    assert read(SimpleNamespace(stats={"mean_slot_ms": None})) is None  # no batch yet


def test_idle_in_pad_outside_forward_counts_only_the_pad_outside_every_forward():
    # idle 1000-1100, 1200-1500, 1700-2000; forwards 1050-1300 and 1600-1650
    run = _serving_run()
    tracing.record("batcher.forward", _ns(1050), _ns(1300))
    tracing.record("batcher.forward", _ns(1600), _ns(1650))
    tracing.record("batcher.pad_stack", _ns(1000), _ns(1150))  # idle outside: 1000-1050
    tracing.record("batcher.pad_stack", _ns(1250), _ns(1400))  # idle outside: 1300-1400
    tracing.record("batcher.pad_stack", _ns(1620), _ns(1640))  # inside a forward: nothing
    tracing.record("batcher.pad_stack", _ns(1750), _ns(1800))  # no forward: 1750-1800
    read = spec.load_reader("idle_in_pad_outside_forward_pct.closed")
    assert read(run) == pytest.approx(100 * 200 / 1000)
    # the pad spans alone, as at a program whose pad runs between forwards
    assert (spec.load_reader("idle_in_pad_stack_pct.closed")(run)
            == pytest.approx(100 * (100 + 150 + 50) / 1000))


def test_idle_in_pad_outside_forward_reads_none_without_the_spans(monkeypatch):
    read = spec.load_reader("idle_in_pad_outside_forward_pct.closed")
    assert read(_serving_run()) is None
    assert read(SimpleNamespace(trace=None, stats={}, forwards=[])) is None
    tracing.record("batcher.pad_stack", _ns(1000), _ns(1150))
    monkeypatch.setattr(program_spans, "buffer", lambda: None)
    assert read(_serving_run()) is None


def test_slot_wait_on_the_programs_own_stats():
    def forward(batch):
        time.sleep(0.05)
        return batch

    b = MicroBatcher(forward, max_batch=1, max_wait_ms=0.0)
    try:
        for f in [b.submit(np.zeros((8, 8, 3), np.uint8)) for _ in range(3)]:
            f.result(timeout=60)
        deadline = time.monotonic() + 30
        while b.stats.snapshot()["batches"] < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        stats = b.stats.snapshot()
    finally:
        b.close()
    # the second and third batches each waited out most of a 50 ms forward
    assert 2 * 40 / 3 <= spec.load_reader("slot_wait_ms.serve")(SimpleNamespace(stats=stats))
