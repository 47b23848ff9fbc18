"""The serving runner: what ``fnst-serve`` builds, without its HTTP layer.
A ``MicroBatcher`` over the program's u8 forward takes requests from one
generator thread, which sends them as the mix's ``arrivals`` module says
(``harness/arrivals/``: an open loop at the cell's rate, or a closed loop
of clients). Each request is timed from its due time to the moment its
output is in the caller's hands. Host spans: "window" (the traced window)
and "forward" (each batch the dispatcher runs, timed on the host clock and
placed on the trace's)."""

import gc
import heapq
import queue
import threading
import time

import numpy as np
import torch

from harness import arrivals, seeded
from harness.systems import for_arch
from harness.trace import Tracer

POOL = 32  # distinct source images; each request crops its own size from one
SAMPLE = 24  # requests judged against the reference
DRAIN_S = 60.0  # how long past the window's close an answer may still come


class Schedule:
    """The seeded requests: due offsets, sizes, the source image and crop of
    each, and the key that draws the judged sample."""

    def __init__(self, traffic: dict, params: dict, seconds: float, seed: int):
        rng = np.random.default_rng(seeded.sub_seed(seed, 10))
        self.arrivals = arrivals.load(traffic["arrivals"])
        n, self.due = self.arrivals.plan(traffic, params, seconds, rng)
        lo, hi = traffic["side_min"], traffic["side_max"]
        self.n = n
        self.h = seeded.spread_sizes(n, lo, hi, rng)
        self.w = seeded.spread_sizes(n, lo, hi, rng)
        self.src = rng.integers(0, POOL, n)
        self.oy = rng.integers(0, hi - self.h + 1)
        self.ox = rng.integers(0, hi - self.w + 1)
        self.key = rng.random(n)

    def rank(self, i: int) -> tuple:
        """The order of the judged sample: the largest request first, then
        the smallest keys."""
        return (-int(self.h[i]) * int(self.w[i]), i)

    def sample(self, answered) -> list:
        """The judged requests among the answered ones: the largest, then
        the ``SAMPLE - 1`` with the smallest keys."""
        answered = list(answered)
        if not answered:
            return []
        first = min(answered, key=self.rank)
        rest = heapq.nsmallest(SAMPLE, (i for i in answered if i != first),
                               key=lambda i: self.key[i])
        return [first] + rest[:SAMPLE - 1]

    def image(self, pool: np.ndarray, i: int) -> np.ndarray:
        return pool[self.src[i], self.oy[i]:self.oy[i] + self.h[i], self.ox[i]:self.ox[i] + self.w[i]]


class Keeper:
    """Keeps the answers that ``Schedule.sample`` will judge while they come:
    the largest answered request's and the ``SAMPLE`` smallest keys'. Which
    ones does not depend on the order the answers came in."""

    def __init__(self, sched: Schedule):
        self.sched = sched
        self.lock = threading.Lock()
        self.heap = []  # (-key, i): the SAMPLE smallest keys
        self.largest = None
        self.outs = {}

    def offer(self, i: int, out) -> None:
        s = self.sched
        with self.lock:
            self.outs[i] = out
            if self.largest is None or s.rank(i) < s.rank(self.largest):
                self.largest, i = i, self.largest
            if i is None:
                return
            heapq.heappush(self.heap, (-s.key[i], i))
            if len(self.heap) > SAMPLE:
                _, i = heapq.heappop(self.heap)
                del self.outs[i]

    def sample(self) -> list:
        """[(i, answer)] in ``Schedule.sample``'s order."""
        idx = self.sched.sample(self.outs)
        return [(i, self.outs[i]) for i in idx]


class Record:
    """What a serving run saw; the metric readers take it."""


def run(cell, seed: int, seconds: float, device, trace: bool, t_start: float,
        variant: str = "program", judge: bool = True) -> Record:
    from fast_neural_style_transfer_tpu_torch.serve.batcher import MicroBatcher, QueueFull

    cfg, traffic, params = cell.config, cell.traffic, cell.params
    system = for_arch(cfg["arch"])
    tracer = Tracer(trace)
    rec = Record()
    rec.config, rec.traffic = cfg, traffic
    side = traffic["side_max"]
    bucket = -(-side // traffic["bucket_multiple"]) * traffic["bucket_multiple"]
    weights = system.make_weights(seed, device)
    forward = system.serve_forward(cfg, weights, traffic, device, variant)
    forwards = []  # (start, end, batch, H, W), host clock

    def timed(batch):
        t0 = time.perf_counter()
        out = forward(batch)
        forwards.append((t0, time.perf_counter(), batch.shape[0], batch.shape[1], batch.shape[2]))
        return out

    batcher = MicroBatcher(timed, max_batch=traffic["max_batch"],
                           max_wait_ms=traffic["max_wait_ms"],
                           max_pending=traffic["max_pending"],
                           bucket_multiple=traffic["bucket_multiple"], warm_size=bucket)
    sched = Schedule(traffic, params, seconds, seed)
    pool = seeded.images(POOL, side, side, seeded.sub_seed(seed, 11), device)
    batcher.ready.wait()
    if batcher.warm_error is not None:
        raise batcher.warm_error
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    forwards.clear()
    n = sched.n
    done = np.full(n, np.nan)
    submitted = np.full(n, np.nan)
    lost = np.zeros(n, bool)  # an error, or no answer at all
    refused = np.zeros(n, bool)  # turned away by the batcher's backpressure
    keeper = Keeper(sched)
    freed = queue.Queue()
    cond = threading.Condition()
    answered = [0]

    def count(i) -> None:
        freed.put(i)
        with cond:
            answered[0] += 1
            cond.notify_all()

    def on_done(i, fut):
        done[i] = time.perf_counter()
        if fut.exception() is not None:
            lost[i] = True
        else:
            keeper.offer(i, fut.result())
        count(i)

    def submit(i):
        submitted[i] = time.perf_counter()
        try:
            fut = batcher.submit(sched.image(pool, i))
        except QueueFull:
            refused[i] = True
            done[i] = submitted[i]
            count(i)
            return
        fut.add_done_callback(lambda f, i=i: on_done(i, f))

    tracer.warm(device)
    gc.collect()
    gc.freeze()  # set-up's objects out of the collector's way: no long pauses in the window
    errors = []

    def generate():
        try:
            sched.arrivals.drive(traffic, n, sched.due, submit, freed, t0, seconds)
        except BaseException as e:  # noqa: BLE001 - raised again below
            errors.append(e)

    tracer.start()
    t0 = time.perf_counter() + 0.05
    rec.setup_s = t0 - t_start
    with tracer.span("window"):
        window_entered = time.perf_counter()
        gen = threading.Thread(target=generate, name="port-bench-arrivals")
        gen.start()
        gen.join()
        sent = int(np.isfinite(submitted).sum())
        with cond:
            cond.wait_for(lambda: answered[0] >= sent,
                          timeout=max(t0 + seconds + DRAIN_S - time.perf_counter(), 0.0))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    rec.trace = tracer.stop()
    if errors:
        batcher.close()
        raise errors[0]
    if rec.trace is not None:  # the dispatcher's forwards, onto the trace's clock
        rec.trace.add_host_spans("forward", [(f[0], f[1]) for f in forwards], window_entered)
    rec.memory_peak_bytes = (torch.cuda.max_memory_allocated(device)
                             if device.type == "cuda" else 0)
    rec.stats = batcher.stats.snapshot()
    batcher.close()
    del forward
    if device.type == "cuda":
        torch.cuda.empty_cache()
    sent_mask = np.isfinite(submitted)  # the requests the window sent
    due_abs = t0 + sched.due if sched.due is not None else submitted.copy()
    lost |= np.isnan(done)
    lost &= sent_mask
    failed = lost | refused
    rec.attempted = int(sent_mask.sum())
    rec.failed = int(failed.sum())
    rec.lost = int(lost.sum())
    lat = (done - due_abs) * 1e3
    lat[failed] = np.inf
    rec.latency_ms = lat[sent_mask]
    rec.lateness_ms = ((submitted - due_abs) * 1e3)[sent_mask]
    rec.due = due_abs[sent_mask]
    rec.t0 = t0
    rec.seconds = seconds
    rec.done = done[sent_mask]
    rec.heights, rec.widths = sched.h[sent_mask], sched.w[sent_mask]
    rec.forwards = forwards
    rec.host_spans = ("forward",)
    rec.idle_label = "batcher"
    rec.checks = {}
    if judge:
        rec.checks = judge_outputs(system, weights, sched, pool, keeper.sample(), traffic, device,
                                   min(SAMPLE, rec.attempted - int(refused.sum())))
    return rec


def judge_outputs(system, weights, sched, pool, kept, traffic, device, size: int) -> dict:
    """The served outputs of the sample, ``[(i, answer)]``, against the
    reference's; a sample short of ``size`` answers (an answer lost) judges
    as 255 levels off."""
    refs = system.reference_u8(weights, [sched.image(pool, i) for i, _ in kept],
                               traffic["bucket_multiple"], device)
    return compare_u8([out for _, out in kept], refs, missing=max(size - len(kept), 0))


def compare_u8(outs, refs, missing: int = 0) -> dict:
    """Per image, the mean |difference| in uint8 levels, its 99.9th
    percentile and the largest difference; each number the worst over the
    images."""
    mean_d, p999_d, max_d = [], [], []
    for o, r in zip(outs, refs):
        d = np.abs(o.astype(np.int16) - r.astype(np.int16))
        mean_d.append(float(d.mean()))
        p999_d.append(float(np.percentile(d, 99.9)))
        max_d.append(float(d.max()))
    if missing:
        mean_d.append(255.0)
        p999_d.append(255.0)
        max_d.append(255.0)
    return {"du8_mean": max(mean_d), "du8_p999": max(p999_d), "du8_max": max(max_d),
            "judged": float(len(outs))}
