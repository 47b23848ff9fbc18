"""The port's serving layer on the CPU: micro-batcher semantics with a fake
forward, and one HTTP round trip through a real CPU Stylizer on port 0."""

import io
import json
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from fast_neural_style_transfer_tpu_torch.infer import Stylizer
from fast_neural_style_transfer_tpu_torch.models import TransformerNet
from fast_neural_style_transfer_tpu_torch.serve import (
    MicroBatcher,
    QueueFull,
    make_server,
)
from fast_neural_style_transfer_tpu_torch.serve import batcher as serve_batcher
from fast_neural_style_transfer_tpu_torch.serve import http as serve_http


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs with several xdist workers
    yield
    torch.set_num_threads(prev)


def test_concurrent_requests_coalesce():
    seen = []

    def forward(batch):
        seen.append(batch.shape[0])
        return batch ^ 0xFF

    b = MicroBatcher(forward, max_batch=8, max_wait_ms=2000.0)
    try:
        imgs = [np.full((32, 32, 3), i, np.uint8) for i in range(8)]
        futs = [b.submit(im) for im in imgs]
        for im, f in zip(imgs, futs):
            np.testing.assert_array_equal(f.result(timeout=60), im ^ 0xFF)
        assert b.stats.snapshot()["mean_batch_occupancy"] == 8.0
        assert seen == [8]
    finally:
        b.close()


def test_mixed_buckets_batch_separately_and_crop():
    shapes = []

    def forward(batch):
        shapes.append(batch.shape)
        return batch

    b = MicroBatcher(forward, max_batch=8, max_wait_ms=500.0, bucket_multiple=64)
    try:
        small = np.arange(40 * 50 * 3, dtype=np.uint8).reshape(40, 50, 3)
        big = np.arange(100 * 90 * 3, dtype=np.uint8).reshape(100, 90, 3)
        f1, f2 = b.submit(small), b.submit(big)
        np.testing.assert_array_equal(f1.result(timeout=60), small)
        np.testing.assert_array_equal(f2.result(timeout=60), big)
        assert sorted(s[1:3] for s in shapes) == [(64, 64), (128, 128)]
    finally:
        b.close()


def test_backpressure_rejects_above_max_pending():
    release = threading.Event()

    def forward(batch):
        release.wait(timeout=60)
        return batch

    b = MicroBatcher(forward, max_batch=1, max_wait_ms=0.0, max_pending=2)
    try:
        img = np.zeros((8, 8, 3), np.uint8)
        futs = [b.submit(img)]
        for _ in range(40):
            try:
                futs.append(b.submit(img))
            except QueueFull:
                break
        else:
            pytest.fail("QueueFull never raised")
        assert b.stats.snapshot()["rejected"] >= 1
        release.set()
        for f in futs:
            f.result(timeout=60)
    finally:
        release.set()
        b.close()


def test_forward_error_reaches_every_caller():
    def forward(batch):
        raise RuntimeError("device fell over")

    b = MicroBatcher(forward, max_batch=4, max_wait_ms=200.0)
    try:
        futs = [b.submit(np.zeros((16, 16, 3), np.uint8)) for _ in range(3)]
        for f in futs:
            with pytest.raises(RuntimeError, match="device fell over"):
                f.result(timeout=60)
    finally:
        b.close()


def _np_pad(img, ph, pw):
    """The batcher's pad as the single-thread batcher did it: ``np.pad``."""
    h, w, _ = img.shape
    mode = "reflect" if (ph - h < h and pw - w < w) else "edge"
    return np.pad(img, ((0, ph - h), (0, pw - w), (0, 0)), mode=mode)


def test_stacked_batch_is_each_request_padded_in_fifo_order():
    """Reflect-padded where the pad is shorter than the side, edge-padded
    where it is not; stacked in submit order."""
    seen = []

    def forward(batch):
        seen.append(batch.copy())
        return batch

    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            for h, w in ((40, 50), (64, 64), (20, 33), (63, 1))]
    b = MicroBatcher(forward, max_batch=4, max_wait_ms=2000.0, bucket_multiple=64)
    try:
        futs = [b.submit(im) for im in imgs]
        for im, f in zip(imgs, futs):
            np.testing.assert_array_equal(f.result(timeout=60), im)
    finally:
        b.close()
    want = np.stack([_np_pad(im, 64, 64) for im in imgs])
    assert len(seen) == 1
    np.testing.assert_array_equal(seen[0], want)


@pytest.mark.parametrize("bucket", [(64, 64), (512, 512), (64, 128)])
def test_pad_into_writes_the_bytes_of_np_pad(bucket):
    """Reflect where both pads are shorter than their sides, else edge,
    for sides from 1 to the bucket's, corners included."""
    ph, pw = bucket
    rng = np.random.default_rng(ph * pw)
    sides = [(h, w) for h in (1, 2, 3, ph // 2, ph // 2 + 1, ph - 1, ph)
             for w in (1, 2, pw // 2, pw // 2 + 1, pw - 1, pw)]
    sides += [(int(rng.integers(1, ph + 1)), int(rng.integers(1, pw + 1))) for _ in range(40)]
    for h, w in sides:
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)[:, ::-1]  # a strided view
        out = np.full((ph, pw, 3), 7, np.uint8)
        serve_batcher._pad_into(out, img)
        np.testing.assert_array_equal(out, _np_pad(img, ph, pw), err_msg=f"{h}x{w}")


def test_pad_runs_on_the_prepare_thread_and_forward_on_the_dispatcher(monkeypatch):
    pads, forwards = [], []
    real_pad = serve_batcher._pad_into

    def pad_into(out, img):
        pads.append(threading.current_thread().name)
        real_pad(out, img)

    def forward(batch):
        forwards.append(threading.current_thread().name)
        return batch

    monkeypatch.setattr(serve_batcher, "_pad_into", pad_into)
    b = MicroBatcher(forward, max_batch=2, max_wait_ms=0.0, warm_size=8)
    try:
        for f in [b.submit(np.zeros((8, 8, 3), np.uint8)) for _ in range(3)]:
            f.result(timeout=60)
    finally:
        b.close()
    assert pads and set(pads) == {"fnst-microbatcher-prep"}
    assert len(forwards) >= 3 and set(forwards) == {"fnst-microbatcher"}  # warm-up too


def test_requests_spaced_wider_than_the_forward_are_not_prepared_ahead():
    b = MicroBatcher(lambda x: x, max_batch=4, max_wait_ms=0.0)
    try:
        for _ in range(4):
            delivered = b.stats.deliver_s
            b.submit(np.zeros((8, 8, 3), np.uint8)).result(timeout=60)
            deadline = time.monotonic() + 30  # the batch ends after its answers
            while b.stats.deliver_s == delivered and time.monotonic() < deadline:
                time.sleep(0.005)
            time.sleep(0.05)
        stats = b.stats.snapshot()
    finally:
        b.close()
    assert stats["batches"] == 4 and stats["prepared_ahead_share"] == 0.0


def test_requests_that_come_while_the_batch_waits_in_the_slot_join_it():
    """The batch in the slot stays open: same-bucket requests that come
    while the forward before it runs are padded into it, in submit order;
    another bucket's request waits for the next batch."""
    entered, release = threading.Event(), threading.Event()
    seen = []

    def forward(batch):
        seen.append(batch.copy())
        entered.set()
        release.wait(timeout=60)
        return batch

    rng = np.random.default_rng(1)
    img = lambda h, w: rng.integers(0, 256, (h, w, 3), dtype=np.uint8)  # noqa: E731
    running, first, late, other = img(16, 16), img(20, 30), [img(40, 50), img(63, 1)], img(70, 70)
    b = MicroBatcher(forward, max_batch=4, max_wait_ms=0.0, bucket_multiple=64)
    try:
        futs = [b.submit(running)]
        assert entered.wait(timeout=30)
        futs.append(b.submit(first))
        deadline = time.monotonic() + 30
        while b._slot is None and time.monotonic() < deadline:
            time.sleep(0.005)
        assert b._slot is not None and len(b._slot.group) == 1
        futs += [b.submit(other)] + [b.submit(im) for im in late]
        while len(b._slot.group) < 3 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert len(b._slot.group) == 3 and len(b._queue) == 1
        release.set()
        for im, f in zip([running, first, other] + late, futs):
            np.testing.assert_array_equal(f.result(timeout=60), im)
        while b.stats.snapshot()["batches"] < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        stats = b.stats.snapshot()
    finally:
        release.set()
        b.close()
    assert [s.shape for s in seen] == [(1, 64, 64, 3), (3, 64, 64, 3), (1, 128, 128, 3)]
    np.testing.assert_array_equal(seen[1], np.stack([_np_pad(im, 64, 64) for im in [first] + late]))
    np.testing.assert_array_equal(seen[2][0], _np_pad(other, 128, 128))
    assert stats["batches"] == 3 and stats["batched_images"] == 5
    assert stats["prepared_ahead_share"] >= 1 / 3  # the second, at least


def test_close_fails_the_prepared_and_the_queued_requests_and_ends_both_threads():
    entered, release = threading.Event(), threading.Event()

    def forward(batch):
        entered.set()
        release.wait(timeout=60)
        return batch

    b = MicroBatcher(forward, max_batch=1, max_wait_ms=0.0)
    closer = None
    try:
        running = b.submit(np.full((8, 8, 3), 1, np.uint8))
        assert entered.wait(timeout=30)
        prepared = b.submit(np.full((8, 8, 3), 2, np.uint8))
        queued = b.submit(np.full((8, 8, 3), 3, np.uint8))
        deadline = time.monotonic() + 30  # one batch prepared, one request left queued
        while b._slot is None and time.monotonic() < deadline:
            time.sleep(0.005)
        assert b._slot is not None and len(b._queue) == 1
        closer = threading.Thread(target=b.close)
        closer.start()
        for f in (prepared, queued):
            with pytest.raises(RuntimeError, match="batcher closed"):
                f.result(timeout=30)
        assert not running.done()
        release.set()
        np.testing.assert_array_equal(running.result(timeout=30), 1)
        closer.join(timeout=30)
        assert not closer.is_alive()
        assert not b._thread.is_alive() and not b._prep_thread.is_alive()
    finally:
        release.set()
        if closer is None:
            b.close()


def test_many_clients_each_get_their_own_answer_under_fast_thread_switches():
    """More submitting threads than cores, the interpreter switching
    threads every 10 µs: every request answered once, with its own image,
    and the counters add up."""
    def forward(batch):
        time.sleep(0.001)
        return batch

    clients, each = 16, 12
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    b = MicroBatcher(forward, max_batch=4, max_wait_ms=1.0, bucket_multiple=16)
    try:
        def client(c):
            for k in range(each):
                side = 8 + (c + k) % 24  # two buckets
                img = np.full((side, side, 3), (c * each + k) % 256, np.uint8)
                np.testing.assert_array_equal(b.submit(img).result(timeout=60), img)
            return c

        with ThreadPoolExecutor(clients) as pool:
            assert sorted(pool.map(client, range(clients))) == list(range(clients))
        deadline = time.monotonic() + 30
        while (b.stats.snapshot()["batched_images"] < clients * each
               and time.monotonic() < deadline):
            time.sleep(0.01)
        stats = b.stats.snapshot()
    finally:
        sys.setswitchinterval(before)
        b.close()
    assert stats["batched_images"] == clients * each
    assert stats["errors"] == 0 and stats["batches"] >= clients * each / 4
    assert 0.0 <= stats["prepared_ahead_share"] <= 1.0


def _png_bytes(arr):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def test_http_round_trip_on_cpu():
    from PIL import Image

    torch.manual_seed(0)
    sty = Stylizer(TransformerNet().state_dict(), device="cpu", bucket_multiple=32)
    srv = make_server(sty.stylize_u8, family="flagship", device=sty.device,
                      port=0, max_batch=4, max_wait_ms=500.0, bucket_multiple=32)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        with urllib.request.urlopen(f"{base}/healthz", timeout=60) as r:
            info = json.load(r)
        assert info["status"] == "ok" and info["device"] == "cpu"
        img = np.random.default_rng(1).integers(0, 255, (30, 40, 3), dtype=np.uint8)
        body = _png_bytes(img)

        def post(_):
            req = urllib.request.Request(f"{base}/stylize?format=png", data=body,
                                         method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                assert r.headers["Content-Type"] == "image/png"
                return np.asarray(Image.open(io.BytesIO(r.read())))

        with ThreadPoolExecutor(max_workers=4) as ex:
            outs = list(ex.map(post, range(4)))
        want = sty.stylize_u8(img)
        for out in outs:
            np.testing.assert_array_equal(out, want)
        stats = srv.batcher.stats.snapshot()
        assert stats["requests"] == 4 and stats["errors"] == 0
        assert stats["batches"] < 4  # some requests shared a batch
        bad = urllib.request.Request(f"{base}/stylize", data=b"nope", method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(bad, timeout=60)
        assert e.value.code == 400
    finally:
        srv.shutdown()
        t.join(timeout=30)
    assert not t.is_alive()


@pytest.mark.parametrize("flags", [["--adain-decoder", "d.npz", "--style", "s.jpg",
                                    "--precision", "int8"], ["--data_parallel"]])
def test_serve_cli_unported_flags_raise(flags, tmp_path, monkeypatch):
    """int8 serves the flagship family only, as in the JAX package (flagship
    int8: tests/test_torch_quantized.py). --data_parallel serves: on the
    CPU its plan is one replica, and a request gets the Stylizer's output
    (two replicas: tests/test_torch_data_parallel.py)."""
    import signal

    from PIL import Image

    ckpt = str(tmp_path / "m.pth")
    torch.save(TransformerNet().state_dict(), ckpt)
    if "--adain-decoder" in flags:
        with pytest.raises((SystemExit, NotImplementedError), match="flagship family only"):
            serve_http.main(["--model", ckpt, "--cpu", *flags])
        return
    img = np.random.default_rng(3).integers(0, 255, (24, 32, 3), dtype=np.uint8)
    want = Stylizer.from_checkpoint(ckpt, device="cpu", precision="f32").stylize_u8(img)
    got, real = {}, serve_http.make_server

    def make_server_on_port_0(forward, **kw):
        kw.update(host="127.0.0.1", port=0, warm_size=0)
        srv = real(forward, **kw)

        def client():
            try:
                req = urllib.request.Request(
                    f"http://127.0.0.1:{srv.server_address[1]}/stylize?format=png",
                    data=_png_bytes(img), method="POST")
                with urllib.request.urlopen(req, timeout=120) as r:
                    got["out"] = np.asarray(Image.open(io.BytesIO(r.read())))
            finally:
                srv.shutdown()

        threading.Thread(target=client, daemon=True).start()
        return srv

    monkeypatch.setattr(serve_http, "make_server", make_server_on_port_0)
    before = signal.getsignal(signal.SIGTERM)
    try:
        serve_http.main(["--model", ckpt, "--cpu", "--precision", "f32", *flags])
    finally:
        signal.signal(signal.SIGTERM, before)
    np.testing.assert_array_equal(got["out"], want)


def test_serve_cli_style_index_serves_the_baked_style(tmp_path, monkeypatch):
    """fnst-serve --style_index 1 on a multi-style checkpoint serves that
    style, baked by Stylizer.from_checkpoint(style=1): one request through
    the CLI's server gets the baked Stylizer's output. On a single-style
    checkpoint --style_index raises the JAX package's ValueError."""
    import signal

    from PIL import Image

    from fast_neural_style_transfer_tpu_torch.models import save_params_npz
    from fast_neural_style_transfer_tpu_torch.models.transformer import InstanceNorm

    torch.manual_seed(0)
    multi = TransformerNet(num_styles=2)
    with torch.no_grad():
        for m in multi.modules():
            if isinstance(m, InstanceNorm):
                m.weight.normal_(1.0, 0.5)
                m.bias.normal_(0.0, 0.3)
    ckpt = str(tmp_path / "multi.npz")
    save_params_npz(multi.state_dict(), ckpt)
    img = np.random.default_rng(2).integers(0, 255, (30, 40, 3), dtype=np.uint8)
    want = Stylizer.from_checkpoint(ckpt, style=1, device="cpu").stylize_u8(img)
    other = Stylizer.from_checkpoint(ckpt, style=0, device="cpu").stylize_u8(img)
    assert not np.array_equal(want, other)
    got = {}
    real = serve_http.make_server

    def make_server_on_port_0(forward, **kw):
        kw.update(host="127.0.0.1", port=0, warm_size=0)
        srv = real(forward, **kw)

        def client():
            try:
                req = urllib.request.Request(
                    f"http://127.0.0.1:{srv.server_address[1]}/stylize?format=png",
                    data=_png_bytes(img), method="POST")
                with urllib.request.urlopen(req, timeout=120) as r:
                    got["out"] = np.asarray(Image.open(io.BytesIO(r.read())))
            finally:
                srv.shutdown()

        threading.Thread(target=client, daemon=True).start()
        return srv

    monkeypatch.setattr(serve_http, "make_server", make_server_on_port_0)
    before = signal.getsignal(signal.SIGTERM)
    try:
        serve_http.main(["--model", ckpt, "--cpu", "--style_index", "1",
                         "--precision", "f32"])
    finally:
        signal.signal(signal.SIGTERM, before)
    np.testing.assert_array_equal(got["out"], want)
    single = str(tmp_path / "m.pth")
    torch.save(TransformerNet().state_dict(), single)
    with pytest.raises(ValueError, match="single-style checkpoint"):
        serve_http.main(["--model", single, "--cpu", "--style_index", "0"])


def test_warm_up_runs_every_batch_size_on_the_dispatcher_thread():
    calls = []

    def forward(batch):
        calls.append((batch.shape, threading.current_thread().name))
        return batch

    b = MicroBatcher(forward, max_batch=3, warm_size=16)
    try:
        assert b.ready.wait(timeout=30) and b.warm_error is None
        assert [c[0] for c in calls] == [(n, 16, 16, 3) for n in (1, 2, 3) for _ in range(2)]
        assert {c[1] for c in calls} == {"fnst-microbatcher"}
        out = b.submit(np.ones((8, 8, 3), np.uint8)).result(timeout=30)
        assert out.shape == (8, 8, 3) and calls[-1][1] == "fnst-microbatcher"
        assert b.stats.snapshot()["batches"] == 1  # warm-up is not traffic
    finally:
        b.close()


def test_make_server_needs_the_device_it_reports():
    """/healthz names the device the forward runs on: the caller must say
    which, or a server on the card would report the CPU."""
    with pytest.raises(TypeError, match="device"):
        make_server(lambda batch: batch, family="flagship", port=0)


def test_make_server_raises_a_failed_warm_up():
    def forward(batch):
        raise RuntimeError("no plan for this shape")

    with pytest.raises(RuntimeError, match="no plan"):
        make_server(forward, family="flagship", device="cpu", port=0, warm_size=16)
