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


def _pad_into(out: np.ndarray, img: np.ndarray) -> None:
    """Write one HWC image into ``out`` (ph, pw, 3), reflect-padded to its
    dims — numpy twin of core.shapes.pad_to_multiple_reflect (edge mode when
    pad >= dim). The bytes of ``np.pad`` (rows first, then columns over
    every row), with one copy of the image and no array of its own."""
    h, w, _ = img.shape
    ph, pw, _ = out.shape
    dh, dw = ph - h, pw - w
    out[:h, :w] = img
    if dh < h and dw < w:
        if dh:
            out[h:, :w] = out[h - 1 - dh:h - 1, :w][::-1]
        if dw:
            out[:, w:] = out[:, w - 1 - dw:w - 1][:, ::-1]
    else:
        out[h:, :w] = out[h - 1:h, :w]
        out[:, w:] = out[:, w - 1:w]


class ServingStats:
    """Lock-protected serving counters + a latency reservoir.

    ``snapshot()`` is what ``GET /stats`` returns: request/batch counts,
    mean batch occupancy (the batching win), e2e latency quantiles over
    the last ``window`` requests, and where the dispatcher's time went:
    the mean linger, pad/stack, forward and deliver per batch, and the mean
    wait of a request from submit to being taken into a batch. A batch's
    deliver time is added once its answers are out, after its count.
    ``mean_slot_ms``: a batch's wait in the handoff slot, from its first
    requests stacked to its forward's start. ``prepared_ahead_share``: the
    share of batches whose first requests were padded and stacked before
    the dispatcher was free for them (the previous batch's answers out), so
    the device did not wait for their host work.
    """

    def __init__(self, window: int = 1024):
        self._lock = threading.Lock()
        self._lat: Deque[float] = deque(maxlen=window)
        self.requests = 0
        self.batches = 0
        self.batched_images = 0
        self.errors = 0
        self.rejected = 0
        self.prepared_ahead = 0  # batches stacked before the dispatcher was free
        # summed seconds
        self.linger_s = 0.0
        self.pad_stack_s = 0.0
        self.forward_s = 0.0
        self.deliver_s = 0.0
        self.slot_s = 0.0
        self.queue_wait_s = 0.0  # over requests, submit to take

    def record_batch(self, n: int, *, linger_s: float = 0.0, pad_stack_s: float = 0.0,
                     forward_s: float = 0.0, queue_wait_s: float = 0.0,
                     slot_s: float = 0.0, prepared_ahead: bool = False) -> None:
        with self._lock:
            self.batches += 1
            self.prepared_ahead += prepared_ahead
            self.batched_images += n
            self.linger_s += linger_s
            self.pad_stack_s += pad_stack_s
            self.forward_s += forward_s
            self.slot_s += slot_s
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
                "mean_slot_ms": per_batch(self.slot_s),
                "mean_queue_wait_ms": (self.queue_wait_s * 1e3 / self.batched_images
                                       if self.batched_images else None),
                "prepared_ahead_share": (self.prepared_ahead / self.batches
                                         if self.batches else None),
            }


class _Prepared:
    """A batch in the handoff slot: its requests padded into the first
    ``len(group)`` rows of a ``max_batch``-row buffer. While the slot holds
    it, the prepare thread pads later same-bucket requests into the next
    rows; ``filling`` is set while one is being written."""

    __slots__ = ("key", "group", "batch_id", "head_ns", "taken_ns", "stacked_ns",
                 "pad_ns", "queue_wait_ns", "batch", "filling")

    def __init__(self, key, group, batch_id, head_ns, taken_ns, stacked_ns, batch):
        self.key, self.group, self.batch_id = key, group, batch_id
        self.head_ns = head_ns  # head request picked
        self.taken_ns = taken_ns  # first requests taken from the queue
        self.stacked_ns = stacked_ns  # ... and padded: the batch enters the slot
        self.pad_ns = stacked_ns - taken_ns  # host pad time, later requests' added
        self.queue_wait_ns = sum(taken_ns - e[3] for e in group)  # submit to take
        self.batch = batch
        self.filling = False


def _fail(group: List, error: BaseException) -> None:
    for _, _, fut, _, _ in group:
        if not fut.done():
            fut.set_exception(error)


class MicroBatcher:
    """Coalesce concurrent single-image requests into device batches.

    ``forward``: a callable taking one uint8 NHWC batch of identical dims
    and returning the stylized uint8 NHWC batch (``Stylizer.stylize_u8``).

    Two threads. The prepare thread (``fnst-microbatcher-prep``) takes the
    oldest request, then waits up to ``max_wait_ms`` for more requests of
    the same shape bucket (returning early the moment ``max_batch`` are on
    hand), and pads each to the bucket in its place in one stacked batch
    (``_pad_into``). FIFO on the head request, so mixed-size traffic cannot
    starve a bucket. It hands the batch to the dispatcher
    (``fnst-microbatcher``) through a slot that holds one batch. While the
    slot holds it, the batch stays open: requests of its bucket that arrive
    meanwhile are padded into its free rows, up to ``max_batch``, as a
    batcher with one thread would have taken them into its next batch once
    its forward ended. The dispatcher runs the warm-up and every forward,
    on the rows filled when it takes the batch, and delivers the answers. So while batch k's
    forward runs, batch k+1 is padded and stacked beside it; when no
    request is queued, a batch is formed only once its head request
    arrives, as with one thread.

    Under a ``torch.profiler`` session (``utils.tracing``) each request
    leaves a ``batcher.queued`` span (submit to take) and a batch a
    ``batcher.linger`` (head picked to its first requests taken),
    ``batcher.pad_stack`` (one for the first requests, one for each that
    joins in the slot), ``batcher.slot`` (first requests stacked to the
    forward's start), ``batcher.forward`` and ``batcher.deliver`` span, with
    the batch's id. The prepare thread records the first three, the
    dispatcher the others. ``batcher.forward`` is a span (the stylizer's
    spans' parent); the others are recorded from the stamps that
    ``ServingStats``' timing counters read. The forward's counter runs
    from the slot's end to the deliver's start.
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
        """``max_pending`` bounds the requests queued; one more batch may
        be held in the slot beside them, and one in the forward.

        ``warm_size`` > 0: before taking requests, the dispatcher thread
        runs two forwards of a warm_size x warm_size batch at every batch
        size 1..max_batch, and ``ready`` is set when it is done. PyTorch
        keeps cuDNN handles and execution plans per thread, so only the
        thread that serves can warm them; a stylizer that keeps a CUDA
        graph per input key captures it on the key's second call
        (``infer/graphs.py``). The prepare thread takes no request before
        ``ready``."""
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self._forward = forward
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self.max_pending = max_pending
        self.bucket_multiple = bucket_multiple
        self.stats = ServingStats()
        self._lock = threading.Lock()
        # the queue grew, the slot filled, grew or emptied, or the batcher closed
        self._cond = threading.Condition(self._lock)
        # entries: (bucket_key, img_u8, future, submit perf_counter_ns, request id)
        self._queue: Deque[Tuple[Tuple[int, int], np.ndarray, Future, int, int]] = deque()
        self._slot: Optional[_Prepared] = None
        self._requests = itertools.count()
        self._batches = itertools.count()
        self._closed = False
        self._warm_size = warm_size
        self.warm_error: Optional[BaseException] = None
        self.ready = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="fnst-microbatcher", daemon=True)
        self._prep_thread = threading.Thread(
            target=self._prepare_loop, name="fnst-microbatcher-prep", daemon=True)
        self._thread.start()
        self._prep_thread.start()

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
            self._cond.notify_all()
        return fut

    def close(self) -> None:
        """Stop both threads; fail the requests still queued and a batch in
        the slot not yet run with "batcher closed". A forward already
        running ends and delivers."""
        with self._cond:
            self._closed = True
            leftovers = list(self._queue)
            self._queue.clear()
            if self._slot is not None:
                leftovers = self._slot.group + leftovers
                self._slot = None
            self._cond.notify_all()
        _fail(leftovers, RuntimeError("batcher closed"))
        self._prep_thread.join(timeout=10)
        self._thread.join(timeout=10)

    # -- prepare side -------------------------------------------------------

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

    def _take_group(self) -> Optional[Tuple[Tuple[int, int], List, int, int]]:
        """Wait for an empty slot and a request, linger, take the group:
        ``(key, group, head_ns, taken_ns)``, or None once closed."""
        with self._cond:
            while (self._slot is not None or not self._queue) and not self._closed:
                self._cond.wait()
            if self._closed:
                return None
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
                return None
            group = self._take_matching(key, self.max_batch)
            return key, group, head_ns, time.perf_counter_ns()

    def _prepare_loop(self) -> None:
        self.ready.wait()
        while True:
            taken = self._take_group()
            if taken is None:
                return
            key, group, head_ns, taken_ns = taken
            (ph, pw), b, n = key, next(self._batches), len(group)
            try:
                batch = np.empty((self.max_batch, ph, pw, 3), np.uint8)
                for i, (_, img, _, _, _) in enumerate(group):
                    _pad_into(batch[i], img)
            except Exception as e:  # noqa: BLE001 — delivered to each caller
                _fail(group, e)
                continue
            stacked_ns = time.perf_counter_ns()
            if tracing.enabled():  # the spans, from the counters' own stamps
                tracing.record("batcher.linger", head_ns, taken_ns, batch=b, n=n)
                tracing.record("batcher.pad_stack", taken_ns, stacked_ns, batch=b, n=n)
                for _, _, _, submit_ns, req in group:
                    tracing.record("batcher.queued", submit_ns, taken_ns, batch=b, req=req)
            prepared = _Prepared(key, group, b, head_ns, taken_ns, stacked_ns, batch)
            with self._cond:
                if self._closed:
                    _fail(group, RuntimeError("batcher closed"))
                    return
                self._slot = prepared
                self._cond.notify_all()
            self._fill(prepared)

    def _fill(self, p: _Prepared) -> None:
        """Pad same-bucket arrivals into ``p``'s free rows while the slot
        holds it; return once the dispatcher has taken it, it is full, or
        the batcher closed."""
        while True:
            with self._cond:
                while (self._slot is p and len(p.group) < self.max_batch
                       and not self._count_matching(p.key)):
                    self._cond.wait()
                if self._slot is not p or len(p.group) >= self.max_batch:
                    return
                (entry,) = self._take_matching(p.key, 1)
                p.filling = True  # the dispatcher waits for this row
            taken_ns = time.perf_counter_ns()
            try:
                _pad_into(p.batch[len(p.group)], entry[1])
                error = None
            except Exception as e:  # noqa: BLE001 — delivered to its caller
                error = e
            padded_ns = time.perf_counter_ns()
            with self._cond:
                p.filling = False
                closed = self._closed
                if error is None and not closed:
                    p.group.append(entry)
                    p.pad_ns += padded_ns - taken_ns
                    p.queue_wait_ns += taken_ns - entry[3]
                self._cond.notify_all()
            if error is not None or closed:
                _fail([entry], error or RuntimeError("batcher closed"))
                continue
            if tracing.enabled():
                tracing.record("batcher.pad_stack", taken_ns, padded_ns, batch=p.batch_id, n=1)
                tracing.record("batcher.queued", entry[3], taken_ns, batch=p.batch_id,
                               req=entry[4])

    # -- dispatcher side ----------------------------------------------------

    def _warm_up(self) -> None:
        try:
            size = self._warm_size
            for b in range(1, self.max_batch + 1):
                for _ in range(2):
                    self._forward(np.zeros((b, size, size, 3), np.uint8))
        except Exception as e:  # noqa: BLE001 — reported by the owner
            self.warm_error = e
        finally:
            self.ready.set()

    def _loop(self) -> None:
        # when the dispatcher was last free for the next batch; read before
        # ``ready``, so no batch can be stacked before it
        free_ns = time.perf_counter_ns()
        if self._warm_size > 0:
            self._warm_up()
        else:
            self.ready.set()
        while True:
            with self._cond:
                while (self._slot is None or self._slot.filling) and not self._closed:
                    self._cond.wait()
                if self._closed:
                    return
                prepared, self._slot = self._slot, None
                self._cond.notify_all()
            self._run_batch(prepared, prepared_ahead=prepared.stacked_ns < free_ns)
            free_ns = time.perf_counter_ns()

    def _run_batch(self, p: _Prepared, prepared_ahead: bool) -> None:
        b, n = p.batch_id, len(p.group)
        try:
            start_ns = time.perf_counter_ns()
            with tracing.span("batcher.forward", batch=b, n=n):  # the stylizer's spans' parent
                out = np.asarray(self._forward(p.batch[:n]))
            done_ns = time.perf_counter_ns()
            # counted before the answers go out, so a caller that reads the
            # stats after its answer finds its batch there
            self.stats.record_batch(
                n, linger_s=(p.taken_ns - p.head_ns) / 1e9, pad_stack_s=p.pad_ns / 1e9,
                forward_s=(done_ns - start_ns) / 1e9, queue_wait_s=p.queue_wait_ns / 1e9,
                slot_s=(start_ns - p.stacked_ns) / 1e9, prepared_ahead=prepared_ahead)
            for i, (_, img, fut, _, _) in enumerate(p.group):
                h, w, _ = img.shape
                fut.set_result(out[i, :h, :w, :])
            delivered_ns = time.perf_counter_ns()
            self.stats.record_deliver((delivered_ns - done_ns) / 1e9)
            if tracing.enabled():
                tracing.record("batcher.slot", p.stacked_ns, start_ns, batch=b, n=n)
                tracing.record("batcher.deliver", done_ns, delivered_ns, batch=b, n=n)
        except Exception as e:  # noqa: BLE001 — delivered to each caller
            _fail(p.group, e)
