"""The port's span recorder (``utils/tracing.py``) on the CPU: off without a
profiler, on from every thread while one runs, native in the chrome trace
on the profiling thread; the batcher's spans and ``ServingStats``' timing
counters; the training step's spans in order."""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fast_neural_style_transfer_tpu_torch.losses import LossTaps, style_targets_from_features
from fast_neural_style_transfer_tpu_torch.models import TransformerNet
from fast_neural_style_transfer_tpu_torch.models.vgg_weights import make_vgg, random_params
from fast_neural_style_transfer_tpu_torch.serve import MicroBatcher, ServingStats
from fast_neural_style_transfer_tpu_torch.train.state import create_train_state
from fast_neural_style_transfer_tpu_torch.train.step import make_train_step
from fast_neural_style_transfer_tpu_torch.utils import tracing
from fast_neural_style_transfer_tpu_torch.utils.image_io import u8_to_network


@pytest.fixture(autouse=True)
def _fresh_buffer():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs with several xdist workers
    tracing.clear()
    yield
    tracing.clear()
    torch.set_num_threads(prev)


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_without_a_profiler_span_is_the_shared_noop_and_records_nothing():
    assert not tracing.enabled()
    a, b = tracing.span("x"), tracing.span("y", batch=3, n=2)
    assert a is b
    with a:
        with b:
            pass
    assert tracing.spans() == []


def test_profiler_gate_is_the_module_flag_seen_from_every_thread():
    """The recorder's gate: a torch upgrade that drops or renames it fails
    here, not silently in the benchmark's metrics."""
    import torch.autograd.profiler as ap

    seen = {}

    def look():
        seen["flag"] = ap._is_profiler_enabled
        seen["native"] = torch._C._autograd._profiler_enabled()

    assert ap._is_profiler_enabled is False
    with _cpu_profile():
        assert ap._is_profiler_enabled is True
        t = threading.Thread(target=look)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    assert ap._is_profiler_enabled is False
    assert seen["flag"] is True
    assert seen["native"] is False  # a thread the session does not record


def test_thread_started_before_the_session_records_with_parents():
    go, done = threading.Event(), threading.Event()
    ident = {}

    def worker():
        ident["t"] = threading.get_ident()
        go.wait(timeout=30)
        with tracing.span("outer", batch=7, n=2):
            with tracing.span("inner", h=4, w=5):
                time.sleep(0.002)
            with tracing.span("inner2"):
                pass
        done.set()

    t = threading.Thread(target=worker)
    t.start()
    with _cpu_profile():
        go.set()
        assert done.wait(timeout=30)
    t.join(timeout=30)
    assert not t.is_alive()
    by = {s.name: s for s in tracing.spans()}
    assert set(by) == {"outer", "inner", "inner2"}
    assert by["outer"].parent is None
    assert by["inner"].parent == by["outer"].id == by["inner2"].parent
    assert {s.thread for s in by.values()} == {ident["t"]}
    assert by["outer"].attrs == {"batch": 7, "n": 2} and by["inner"].attrs == {"h": 4, "w": 5}
    assert by["outer"].start_ns <= by["inner"].start_ns < by["inner"].end_ns
    assert by["inner"].end_ns - by["inner"].start_ns >= 2_000_000
    assert by["inner2"].end_ns <= by["outer"].end_ns


def test_spans_from_many_threads_keep_unique_ids_and_their_own_parents():
    threads, rounds = 2 * (os.cpu_count() or 4), 200
    start = threading.Barrier(threads + 1, timeout=30)

    def worker():
        start.wait()
        for _ in range(rounds):
            with tracing.span("outer"):
                with tracing.span("inner"):
                    pass

    pool = [threading.Thread(target=worker) for _ in range(threads)]
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in pool:
            t.start()
        with _cpu_profile():
            start.wait()
            for t in pool:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in pool)
    spans = tracing.spans()
    assert len(spans) == 2 * threads * rounds
    assert len({s.id for s in spans}) == len(spans)
    outer = {s.id: s.thread for s in spans if s.name == "outer"}
    for s in spans:
        if s.name == "inner":
            assert outer[s.parent] == s.thread
        else:
            assert s.parent is None


def test_span_on_the_profiling_thread_is_a_user_annotation_in_the_trace(tmp_path):
    with _cpu_profile() as prof:
        with tracing.span("stylize.launch", n=1):
            torch.ones(4).sum()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert names.count("stylize.launch") == 1
    assert [s.name for s in tracing.spans()] == ["stylize.launch"]


def test_batcher_spans_and_counters():
    sleep_s, wait_ms, slack_s = 0.05, 100.0, 0.5

    def forward(batch):
        with tracing.span("fake.forward"):
            time.sleep(sleep_s)
        return batch

    b = MicroBatcher(forward, max_batch=4, max_wait_ms=wait_ms)
    try:
        with _cpu_profile():
            futs = [b.submit(np.full((16, 16, 3), i, np.uint8)) for i in range(2)]
            for i, f in enumerate(futs):
                np.testing.assert_array_equal(f.result(timeout=60), i)
            deadline = time.monotonic() + 30  # the dispatcher ends the batch after the answers
            while b.stats.deliver_s == 0.0 and time.monotonic() < deadline:
                time.sleep(0.01)
        stats = b.stats.snapshot()
    finally:
        b.close()
    spans = tracing.spans()
    by = {s.name: [x for x in spans if x.name == s.name] for s in spans}
    queued = by["batcher.queued"]
    assert len(queued) == 2
    assert {s.attrs["batch"] for s in queued} == {0}
    assert sorted(s.attrs["req"] for s in queued) == [0, 1]
    for name in ("batcher.linger", "batcher.pad_stack", "batcher.forward", "batcher.deliver"):
        (s,) = by[name]
        assert s.attrs == {"batch": 0, "n": 2}, name
    (fwd,), (child,) = by["batcher.forward"], by["fake.forward"]
    assert child.parent == fwd.id
    ms = lambda s: (s.end_ns - s.start_ns) / 1e6  # noqa: E731
    assert wait_ms <= ms(by["batcher.linger"][0]) < wait_ms + slack_s * 1e3
    assert sleep_s * 1e3 <= ms(fwd) < (sleep_s + slack_s) * 1e3
    # the counters: one batch of two
    assert stats["batches"] == 1 and stats["batched_images"] == 2
    assert wait_ms <= stats["mean_linger_ms"] < wait_ms + slack_s * 1e3
    assert sleep_s * 1e3 <= stats["mean_forward_ms"] < (sleep_s + slack_s) * 1e3
    assert 0.0 <= stats["mean_pad_stack_ms"] < slack_s * 1e3
    assert 0.0 <= stats["mean_deliver_ms"] < slack_s * 1e3
    # both were queued from submit through the whole linger
    assert wait_ms <= stats["mean_queue_wait_ms"] < wait_ms + slack_s * 1e3
    assert stats["mean_queue_wait_ms"] == pytest.approx(
        np.mean([ms(s) for s in queued]), abs=1e-3)
    # spans and counters read the same stamps: take, stack, the forward's
    # start (the slot's end: the forward starts on the dispatcher, after
    # the stack) and end (the deliver's start)
    (linger,), (pad,), (slot,), (deliver,) = (
        by[n] for n in ("batcher.linger", "batcher.pad_stack", "batcher.slot", "batcher.deliver"))
    assert {s.end_ns for s in queued} == {linger.end_ns} == {pad.start_ns}
    assert slot.attrs == {"batch": 0, "n": 2} and slot.start_ns == pad.end_ns
    assert pad.end_ns <= slot.end_ns <= fwd.start_ns and fwd.end_ns <= deliver.start_ns
    assert stats["mean_linger_ms"] == pytest.approx(ms(linger), abs=1e-6)
    assert stats["mean_pad_stack_ms"] == pytest.approx(ms(pad), abs=1e-6)
    assert stats["mean_slot_ms"] == pytest.approx(ms(slot), abs=1e-6)
    assert stats["mean_deliver_ms"] == pytest.approx(ms(deliver), abs=1e-6)
    assert stats["mean_forward_ms"] == pytest.approx(
        (deliver.start_ns - slot.end_ns) / 1e6, abs=1e-6)
    assert stats["prepared_ahead_share"] == 0.0  # one batch, the dispatcher idle before it


def test_next_batch_is_padded_and_stacked_while_the_forward_runs():
    sleep_s = 0.1

    def forward(batch):
        time.sleep(sleep_s)
        return batch

    # a long linger that ends the moment two are on hand: each batch is a pair
    b = MicroBatcher(forward, max_batch=2, max_wait_ms=2000.0)
    try:
        with _cpu_profile():
            futs = [b.submit(np.full((16, 16, 3), i, np.uint8)) for i in range(4)]
            for i, f in enumerate(futs):
                np.testing.assert_array_equal(f.result(timeout=60), i)
            deadline = time.monotonic() + 30
            while b.stats.snapshot()["batches"] < 2 and time.monotonic() < deadline:
                time.sleep(0.01)
        stats = b.stats.snapshot()
    finally:
        b.close()
    spans = tracing.spans()
    of = lambda name, batch: [s for s in spans  # noqa: E731
                              if s.name == name and s.attrs["batch"] == batch]
    assert sorted(s.attrs["req"] for s in of("batcher.queued", 0)) == [0, 1]
    assert sorted(s.attrs["req"] for s in of("batcher.queued", 1)) == [2, 3]
    (fwd0,), (pad1,), (fwd1,) = (of("batcher.forward", 0), of("batcher.pad_stack", 1),
                                 of("batcher.forward", 1))
    assert pad1.end_ns < fwd0.end_ns <= fwd1.start_ns
    assert pad1.thread != fwd0.thread
    (slot1,) = of("batcher.slot", 1)  # batch 1 waited in the slot through batch 0's forward
    assert slot1.start_ns == pad1.end_ns < fwd0.end_ns and slot1.end_ns <= fwd1.start_ns
    assert stats["batches"] == 2 and stats["prepared_ahead_share"] == 0.5


def test_a_request_that_joins_the_batch_in_the_slot_leaves_its_own_spans():
    entered, release = threading.Event(), threading.Event()

    def forward(batch):
        entered.set()
        release.wait(timeout=60)
        return batch

    b = MicroBatcher(forward, max_batch=4, max_wait_ms=0.0)
    try:
        with _cpu_profile():
            futs = [b.submit(np.full((16, 16, 3), 0, np.uint8))]
            assert entered.wait(timeout=30)
            futs.append(b.submit(np.full((16, 16, 3), 1, np.uint8)))
            deadline = time.monotonic() + 30
            while b._slot is None and time.monotonic() < deadline:
                time.sleep(0.005)
            futs.append(b.submit(np.full((16, 16, 3), 2, np.uint8)))
            while len(b._slot.group) < 2 and time.monotonic() < deadline:
                time.sleep(0.005)
            release.set()
            for i, f in enumerate(futs):
                np.testing.assert_array_equal(f.result(timeout=60), i)
            while b.stats.snapshot()["batches"] < 2 and time.monotonic() < deadline:
                time.sleep(0.01)
        stats = b.stats.snapshot()
    finally:
        release.set()
        b.close()
    spans = tracing.spans()
    of = lambda name: [s for s in spans  # noqa: E731
                       if s.name == name and s.attrs["batch"] == 1]
    first, joined = sorted(of("batcher.pad_stack"), key=lambda s: s.start_ns)
    assert first.attrs["n"] == 1 and joined.attrs["n"] == 1
    (slot,), (fwd,) = of("batcher.slot"), of("batcher.forward")
    assert slot.start_ns == first.end_ns < joined.start_ns < joined.end_ns <= slot.end_ns
    assert fwd.attrs["n"] == 2
    by_req = {s.attrs["req"]: s for s in of("batcher.queued")}
    assert sorted(by_req) == [1, 2]
    assert by_req[1].end_ns == first.start_ns and by_req[2].end_ns == joined.start_ns
    ms = lambda s: (s.end_ns - s.start_ns) / 1e6  # noqa: E731
    # the counters sum a batch's pads and its requests' waits
    pads = [s for s in spans if s.name == "batcher.pad_stack"]
    assert stats["mean_pad_stack_ms"] == pytest.approx(sum(map(ms, pads)) / 2, abs=1e-6)
    queued = [s for s in spans if s.name == "batcher.queued"]
    assert stats["mean_queue_wait_ms"] == pytest.approx(sum(map(ms, queued)) / 3, abs=1e-6)


def test_batcher_counters_run_without_a_profiler():
    b = MicroBatcher(lambda x: x, max_batch=2, max_wait_ms=0.0)
    try:
        assert b.stats.snapshot()["mean_linger_ms"] is None
        b.submit(np.zeros((8, 8, 3), np.uint8)).result(timeout=60)
        stats = b.stats.snapshot()
    finally:
        b.close()
    assert stats["batches"] == 1 and stats["mean_forward_ms"] >= 0.0
    assert stats["mean_queue_wait_ms"] >= 0.0
    assert tracing.spans() == []


def test_serving_stats_count_a_batch_given_only_its_size():
    stats = ServingStats()
    stats.record_batch(3)
    stats.record_batch(1, forward_s=0.004)
    snap = stats.snapshot()
    assert snap["batches"] == 2 and snap["batched_images"] == 4
    assert snap["mean_forward_ms"] == pytest.approx(2.0)
    assert snap["mean_linger_ms"] == snap["mean_deliver_ms"] == 0.0
    assert snap["mean_queue_wait_ms"] == 0.0


def test_train_step_spans_in_order():
    torch.manual_seed(0)
    hw = 16
    taps = LossTaps()
    vgg = make_vgg(random_params(0), "cpu")
    style = torch.rand(1, hw, hw, 3) * 2 - 1
    with torch.no_grad():
        grams = style_targets_from_features(vgg(style, taps.style_taps))
    state = create_train_state(TransformerNet(), 1e-3, 10)
    step = make_train_step(lr=1e-3, total_steps=10, dropout=False)
    batch = u8_to_network(torch.randint(0, 256, (2, hw, hw, 3), dtype=torch.uint8))
    with _cpu_profile():
        metrics = step(state, vgg, batch, grams)
    assert torch.isfinite(metrics["loss"])
    got = [(s.name, s.attrs) for s in tracing.spans()]
    assert got == [(n, {"n": 2}) for n in ("train.loss", "train.grad", "train.sync",
                                           "train.update")]
    ends = [(s.start_ns, s.end_ns) for s in tracing.spans()]
    assert all(a[1] <= b[0] for a, b in zip(ends, ends[1:]))


def test_stytr2_stage_spans_nest_in_the_launch_and_carry_device_time_under_a_profiler():
    """The four ``stytr2.*`` stage spans lie inside ``stylize.launch`` in
    order, each with a device time (on the CPU the span's own) and the
    attention launches of its stage under ``ops``; without a profiler there
    are none. The counters count either way."""
    from fast_neural_style_transfer_tpu_torch.infer.stytr2 import TransformerStylizer
    from fast_neural_style_transfer_tpu_torch.models.stytr2 import StyTr2

    widths = dict(dim_feedforward=64, num_encoder_layers=2, num_decoder_layers=1)
    torch.manual_seed(0)
    rng = np.random.default_rng(0)
    sty = TransformerStylizer(StyTr2(**widths).state_dict(), device="cpu")
    sty.set_style_u8(rng.integers(0, 256, (32, 40, 3), dtype=np.uint8))
    x = rng.integers(0, 256, (2, 30, 32, 3), dtype=np.uint8)
    sty.stylize_u8(x)
    assert tracing.spans() == []
    with _cpu_profile():
        sty.stylize_u8(x)
    assert sty.style_encodes == 1 and sty.attention_launches == 2 + 2 * (2 + 2)
    spans = tracing.spans()
    (launch,) = [s for s in spans if s.name == "stylize.launch"]
    stages = [s for s in spans if s.name.startswith("stytr2.")]
    assert [s.name for s in stages] == ["stytr2.embed", "stytr2.encode", "stytr2.decode",
                                        "stytr2.cnn"]
    for a, b in zip(stages, stages[1:]):
        assert a.end_ns <= b.start_ns
    for s in stages:
        assert s.parent == launch.id and launch.start_ns <= s.start_ns < s.end_ns <= launch.end_ns
        assert s.attrs["n"] == 2 and (s.attrs["h"], s.attrs["w"]) == (64, 64)
        assert tracing.device_ms(s) == pytest.approx((s.end_ns - s.start_ns) / 1e6)
        assert tracing.device_ms(s) > 0
    assert [s.attrs.get("ops") for s in stages] == [None, 2, 2, None]
    assert all(tracing.device_ms(s) is None for s in spans if not s.name.startswith("stytr2."))
