"""Online micro-batching for the serving path.

Every forward pays host->device copies and launch overhead, and throughput
grows with the batch dimension until the card saturates, so the server
coalesces concurrent requests into one NHWC batch before touching the card.

Shape policy: requests are grouped by their (H, W) *bucket* (the same
``bucket_multiple`` rounding the Stylizer pads to), so a batch only ever
contains images that pad to identical dims. Mixed-size traffic degrades
gracefully to smaller batches.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Callable, Deque, List, Optional, Tuple

import numpy as np

from fast_neural_style_transfer_tpu_torch.core.shapes import bucket_hw
from fast_neural_style_transfer_tpu_torch.utils import tracing

__all__ = ["MicroBatcher", "QueueFull", "ServingStats"]


class QueueFull(RuntimeError):
    """Backpressure signal: more than ``max_pending`` requests in flight."""


def _pad_to(img: np.ndarray, ph: int, pw: int) -> np.ndarray:
    """Reflect-pad one HWC image to (ph, pw) — numpy twin of
    core.shapes.pad_to_multiple_reflect (edge mode when pad >= dim)."""
    h, w, _ = img.shape
    dh, dw = ph - h, pw - w
    if dh == 0 and dw == 0:
        return img
    mode = "reflect" if (dh < h and dw < w) else "edge"
    return np.pad(img, ((0, dh), (0, dw), (0, 0)), mode=mode)


class ServingStats:
    """Lock-protected serving counters + a latency reservoir.

    ``snapshot()`` is what ``GET /stats`` returns: request/batch counts,
    mean batch occupancy (the batching win), e2e latency quantiles over
    the last ``window`` requests, and where the dispatcher's time went:
    the mean linger, pad/stack, forward and deliver per batch, and the mean
    wait of a request from submit to being taken into a batch. A batch's
    deliver time is added once its answers are out, after its count.
    """

    def __init__(self, window: int = 1024):
        self._lock = threading.Lock()
        self._lat: Deque[float] = deque(maxlen=window)
        self.requests = 0
        self.batches = 0
        self.batched_images = 0
        self.errors = 0
        self.rejected = 0
        # summed seconds
        self.linger_s = 0.0
        self.pad_stack_s = 0.0
        self.forward_s = 0.0
        self.deliver_s = 0.0
        self.queue_wait_s = 0.0  # over requests, submit to take

    def record_batch(self, n: int, *, linger_s: float = 0.0, pad_stack_s: float = 0.0,
                     forward_s: float = 0.0, queue_wait_s: float = 0.0) -> None:
        with self._lock:
            self.batches += 1
            self.batched_images += n
            self.linger_s += linger_s
            self.pad_stack_s += pad_stack_s
            self.forward_s += forward_s
            self.queue_wait_s += queue_wait_s

    def record_deliver(self, seconds: float) -> None:
        with self._lock:
            self.deliver_s += seconds

    def record_request(self, latency_s: float, ok: bool) -> None:
        with self._lock:
            self.requests += 1
            if ok:
                self._lat.append(latency_s)
            else:
                self.errors += 1

    def record_rejected(self) -> None:
        with self._lock:
            self.rejected += 1

    def snapshot(self) -> dict:
        with self._lock:
            lat = sorted(self._lat)
            q = (lambda p: lat[min(len(lat) - 1, int(p * len(lat)))]
                 if lat else None)
            per_batch = (lambda s: s * 1e3 / self.batches if self.batches else None)
            return {
                "requests": self.requests,
                "errors": self.errors,
                "rejected": self.rejected,
                "batches": self.batches,
                "batched_images": self.batched_images,
                "mean_batch_occupancy": (
                    self.batched_images / self.batches if self.batches else None),
                "latency_p50_ms": None if q(0.5) is None else q(0.5) * 1e3,
                "latency_p95_ms": None if q(0.95) is None else q(0.95) * 1e3,
                "mean_linger_ms": per_batch(self.linger_s),
                "mean_pad_stack_ms": per_batch(self.pad_stack_s),
                "mean_forward_ms": per_batch(self.forward_s),
                "mean_deliver_ms": per_batch(self.deliver_s),
                "mean_queue_wait_ms": (self.queue_wait_s * 1e3 / self.batched_images
                                       if self.batched_images else None),
            }


class MicroBatcher:
    """Coalesce concurrent single-image requests into device batches.

    ``forward``: a callable taking one uint8 NHWC batch of identical dims
    and returning the stylized uint8 NHWC batch (``Stylizer.stylize_u8``).

    The dispatcher takes the oldest request, then waits up to
    ``max_wait_ms`` for more requests of the same shape bucket (returning
    early the moment ``max_batch`` are on hand). FIFO on the head request,
    so mixed-size traffic cannot starve a bucket.

    Under a ``torch.profiler`` session (``utils.tracing``) each request
    leaves a ``batcher.queued`` span (submit to take), and each batch a
    ``batcher.linger`` (head picked to group taken), ``batcher.pad_stack``,
    ``batcher.forward`` and ``batcher.deliver`` span, with the batch's id;
    all but ``batcher.forward`` (the stylizer's spans' parent) are recorded
    from the stamps ``ServingStats``' timing counters read.
    """

    def __init__(
        self,
        forward: Callable[[np.ndarray], np.ndarray],
        *,
        max_batch: int = 8,
        max_wait_ms: float = 5.0,
        max_pending: int = 256,
        bucket_multiple: int = 64,
        warm_size: int = 0,
    ):
        """``warm_size`` > 0: before taking requests, the dispatcher thread
        runs one forward of a warm_size x warm_size batch at every batch
        size 1..max_batch, and ``ready`` is set when it is done. PyTorch
        keeps cuDNN handles and execution plans per thread, so only the
        thread that serves can warm them."""
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self._forward = forward
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self.max_pending = max_pending
        self.bucket_multiple = bucket_multiple
        self.stats = ServingStats()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        # entries: (bucket_key, img_u8, future, submit perf_counter_ns, request id)
        self._queue: Deque[Tuple[Tuple[int, int], np.ndarray, Future, int, int]] = deque()
        self._requests = itertools.count()
        self._batches = itertools.count()
        self._closed = False
        self._warm_size = warm_size
        self.warm_error: Optional[BaseException] = None
        self.ready = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="fnst-microbatcher", daemon=True)
        self._thread.start()

    # -- client side --------------------------------------------------------

    def submit(self, img_u8: np.ndarray) -> "Future[np.ndarray]":
        """Enqueue one HWC uint8 image; resolves to the stylized image."""
        if img_u8.ndim != 3 or img_u8.shape[-1] != 3:
            raise ValueError(f"expected (H, W, 3) uint8, got {img_u8.shape}")
        if img_u8.dtype != np.uint8:
            raise TypeError(f"expected uint8, got {img_u8.dtype}")
        key = bucket_hw(img_u8.shape[0], img_u8.shape[1], self.bucket_multiple)
        fut: Future = Future()
        with self._cond:
            if self._closed:
                raise RuntimeError("batcher is closed")
            if len(self._queue) >= self.max_pending:
                self.stats.record_rejected()
                raise QueueFull(
                    f"{len(self._queue)} requests pending (max_pending="
                    f"{self.max_pending})")
            self._queue.append((key, img_u8, fut, time.perf_counter_ns(), next(self._requests)))
            self._cond.notify()
        return fut

    def close(self) -> None:
        """Stop the dispatcher; fail any requests still queued."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._thread.join(timeout=10)
        with self._cond:
            leftovers = list(self._queue)
            self._queue.clear()
        for _, _, fut, _, _ in leftovers:
            fut.set_exception(RuntimeError("batcher closed"))

    # -- dispatcher side ----------------------------------------------------

    def _take_matching(self, key: Tuple[int, int], limit: int) -> List:
        """Pop up to ``limit`` same-bucket entries, preserving the relative
        order of everything left behind. Caller holds the lock."""
        taken, rest = [], deque()
        while self._queue and len(taken) < limit:
            entry = self._queue.popleft()
            (taken if entry[0] == key else rest).append(entry)
        rest.extend(self._queue)
        self._queue = rest
        return taken

    def _count_matching(self, key: Tuple[int, int]) -> int:
        return sum(1 for e in self._queue if e[0] == key)

    def _warm_up(self) -> None:
        try:
            size = self._warm_size
            for b in range(1, self.max_batch + 1):
                self._forward(np.zeros((b, size, size, 3), np.uint8))
        except Exception as e:  # noqa: BLE001 — reported by the owner
            self.warm_error = e
        finally:
            self.ready.set()

    def _loop(self) -> None:
        if self._warm_size > 0:
            self._warm_up()
        else:
            self.ready.set()
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    self._cond.wait()
                if self._closed:
                    return
                head_ns = time.perf_counter_ns()
                key = self._queue[0][0]
                # Linger for co-batchable requests only when under-full and
                # the window is positive; the head request's clock started
                # at submit so the linger is bounded by max_wait total.
                if (self.max_wait_s > 0
                        and self._count_matching(key) < self.max_batch):
                    deadline = time.monotonic() + self.max_wait_s
                    while (self._count_matching(key) < self.max_batch
                           and not self._closed):
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            break
                        self._cond.wait(timeout=remaining)
                if self._closed:
                    return
                group = self._take_matching(key, self.max_batch)
                taken_ns = time.perf_counter_ns()
            self._run_batch(key, group, head_ns, taken_ns)

    def _run_batch(self, key: Tuple[int, int], group: List, head_ns: int,
                   taken_ns: int) -> None:
        ph, pw = key
        b, n = next(self._batches), len(group)
        try:
            batch = np.stack([_pad_to(img, ph, pw) for _, img, _, _, _ in group])
            stacked_ns = time.perf_counter_ns()
            with tracing.span("batcher.forward", batch=b, n=n):  # the stylizer's spans' parent
                out = np.asarray(self._forward(batch))
            done_ns = time.perf_counter_ns()
            # counted before the answers go out, so a caller that reads the
            # stats after its answer finds its batch there
            self.stats.record_batch(
                n, linger_s=(taken_ns - head_ns) / 1e9, pad_stack_s=(stacked_ns - taken_ns) / 1e9,
                forward_s=(done_ns - stacked_ns) / 1e9,
                queue_wait_s=sum(taken_ns - e[3] for e in group) / 1e9)
            for i, (_, img, fut, _, _) in enumerate(group):
                h, w, _ = img.shape
                fut.set_result(out[i, :h, :w, :])
            delivered_ns = time.perf_counter_ns()
            self.stats.record_deliver((delivered_ns - done_ns) / 1e9)
            if tracing.enabled():  # the spans, from the counters' own stamps
                for name, a, z in (("batcher.linger", head_ns, taken_ns),
                                   ("batcher.pad_stack", taken_ns, stacked_ns),
                                   ("batcher.deliver", done_ns, delivered_ns)):
                    tracing.record(name, a, z, batch=b, n=n)
                for _, _, _, submit_ns, req in group:
                    tracing.record("batcher.queued", submit_ns, taken_ns, batch=b, req=req)
        except Exception as e:  # noqa: BLE001 — delivered to each caller
            for _, _, fut, _, _ in group:
                if not fut.done():
                    fut.set_exception(e)
