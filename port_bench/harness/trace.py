"""The ``--trace 1`` run: ``torch.profiler`` over the measured window, and
the reduction of its trace to device intervals and the harness's own host
spans (``torch.profiler.record_function``, so both lie on the trace's
clock). Device busy time is the union of the device's operations, never a
sum: the input pipeline's copy stream overlaps the compute stream."""

import contextlib
import json
import os
import re
import tempfile
from collections import defaultdict

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


class Tracer:
    """Spans that cost nothing with tracing off; with it on, a profiler
    started by ``start`` and reduced by ``stop``."""

    def __init__(self, on: bool):
        self.on = on
        self._prof = None

    def span(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(name)

    def warm(self, device) -> None:
        """Profile one small operation, so that the profiler's own first
        start (CUPTI's set-up, seconds) falls in set-up, not in the window."""
        if self.on:
            import torch
            self.start()
            torch.ones(8, device=device).sum().item()
            self._prof.stop()
            self._prof = None

    def start(self) -> None:
        if self.on:
            import torch
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
            self._prof = profile(activities=acts)
            self._prof.start()

    def stop(self):
        """-> the window's ``Trace``, or None with tracing off."""
        if not self.on:
            return None
        self._prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")  # under TMPDIR
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self._prof = None
        return Trace(events)


def short_name(name: str) -> str:
    """A kernel's name without return type, namespace, template arguments
    and parameters."""
    n = re.sub(r"^void ", "", name)
    n = n.replace("(anonymous namespace)::", "")
    depth, cut = 0, len(n)
    for i, ch in enumerate(n):
        if ch in "<(" and depth == 0:
            cut = i
            break
    head = n[:cut].split("::")[-1].strip()
    if head.lower() == "kernel" and cut < len(n):  # cutlass::Kernel<the_real_name, ...>
        head = re.split(r"[<>,( ]", n[cut + 1:])[0].split("::")[-1] or head
    return (head or name)[:64]


def union(intervals):
    """Merged, sorted, non-overlapping (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def covered(merged, start: float, end: float) -> float:
    """Length of ``[start, end)`` that merged intervals cover."""
    total = 0.0
    for s, e in merged:
        if e <= start:
            continue
        if s >= end:
            break
        total += min(e, end) - max(s, start)
    return total


class Trace:
    """Device operations (name, start, end) and host spans by name, in
    microseconds on the trace's clock; ``window`` is the harness's
    "window" span."""

    def __init__(self, events):
        self.ops = []
        self.spans = defaultdict(list)
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat = e.get("cat")
            s, end = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            if cat in DEVICE_CATEGORIES:
                self.ops.append((e.get("name", "?"), s, end))
            elif cat == "user_annotation":
                self.spans[e["name"]].append((s, end))
        if not self.spans.get("window"):
            raise RuntimeError("the trace holds no 'window' span")
        self.window = self.spans["window"][0]
        w0, w1 = self.window
        self.ops = [o for o in self.ops if o[2] > w0 and o[1] < w1]
        self.merged = union([(max(s, w0), min(e, w1)) for _, s, e in self.ops])

    def add_host_spans(self, name: str, ranges, window_entered: float) -> None:
        """Host-clock ranges (``time.perf_counter`` seconds) as spans on the
        trace's clock, anchored where the "window" span began (the host read
        ``window_entered`` just inside it). The profiler records
        ``record_function`` spans of the thread that started it only."""
        at = self.window[0] - window_entered * 1e6
        self.spans[name].extend((s * 1e6 + at, e * 1e6 + at) for s, e in ranges)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.merged) / 1e6

    def busy_within(self, ranges) -> float:
        """Device-busy seconds inside the given host ranges (microseconds)."""
        return sum(covered(self.merged, s, e) for s, e in ranges) / 1e6

    def kernel_seconds(self, pattern: str) -> float:
        """Summed device time of the operations whose short name matches."""
        rx = re.compile(pattern)
        return sum(e - s for n, s, e in self.ops if rx.search(short_name(n))) / 1e6

    def breakdown(self, host_spans, other: str, top: int = 10) -> dict:
        """The device operations that took most time (by short name), and
        the longest idle gaps inside the window, each named by the host span
        its middle falls in (``other`` where none)."""
        by_name = defaultdict(float)
        for n, s, e in self.ops:
            by_name[short_name(n)] += (e - s) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps, prev = [], self.window[0]
        for s, e in self.merged + [[self.window[1], self.window[1]]]:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        named = []
        for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
            mid = 0.5 * (s + e)
            label = next((h for h in host_spans
                          if any(a <= mid < b for a, b in self.spans.get(h, ()))), other)
            named.append([label, (e - s) / 1e6])
        return {"device_ops": [list(kv) for kv in ops], "idle_gaps": named}
