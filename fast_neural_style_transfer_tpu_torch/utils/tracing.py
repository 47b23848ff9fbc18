"""Named host spans at the port's layer boundaries, recorded only while a
``torch.profiler`` session runs in the process.

``span(name, ...)`` times a block on ``time.perf_counter_ns`` and keeps the
name, the thread, the start and end, the attributes given (``batch``,
``req``, ``n``, ``h``, ``w``) and the id of the enclosing span on the same
thread; ``record`` adds a span whose ends were read elsewhere (a request's
wait in a queue). Spans go to one bounded in-memory buffer, read with
``spans()`` and emptied with ``clear()``.

With no profiler running, ``span`` returns one shared no-op context and
reads no clock. A session sets ``torch.autograd.profiler._is_profiler_enabled``
for every thread, but records ``record_function`` ranges only from the
thread that started it; a span opened on that thread is also entered as
``record_function(name)``, so it lies in the exported chrome trace on the
device's clock. Spans of other threads (the batcher's dispatcher) are in
the buffer only, on the host clock.

``stage(name, device, ...)`` is a span that also carries its stage's device
time: on a CUDA device two timing events recorded on the current stream at
its bounds, read by ``device_ms`` once the work is done (after the
window's synchronize); on the CPU, whose work is done when the host returns,
the span's own bounds. ``count``, a callable read at both bounds, puts the
difference under the span's ``ops`` (a stage's attention launches). Like
``span``, it records nothing and reads no clock without a profiler.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _profiler

__all__ = ["Span", "clear", "device_ms", "enabled", "record", "span", "spans", "stage"]

BUFFER_SPANS = 1 << 17


class Span(NamedTuple):
    name: str
    id: int
    parent: Optional[int]  # the enclosing span on the same thread
    thread: int
    start_ns: int  # time.perf_counter_ns()
    end_ns: int
    attrs: dict
    device: Any = None  # a stage's (start, end) CUDA events, or HOST


_BUFFER: Deque[Span] = deque(maxlen=BUFFER_SPANS)
_IDS = itertools.count(1)
_LOCAL = threading.local()
_NOOP = contextlib.nullcontext()
HOST = "host"  # a CPU stage: its device time is the span's own


def enabled() -> bool:
    """True while a ``torch.profiler`` session runs, from any thread."""
    return _profiler._is_profiler_enabled


def _stack() -> List[int]:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


def _attrs(batch, req, n, h, w) -> dict:
    return {k: v for k, v in (("batch", batch), ("req", req), ("n", n), ("h", h), ("w", w))
            if v is not None}


class _Open:
    __slots__ = ("name", "attrs", "id", "parent", "start", "native")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        self.id = next(_IDS)
        stack.append(self.id)
        self.native = None
        # each clock read comes before the profiler's: its own bookkeeping,
        # after it takes a time, stays out of the span
        self.start = time.perf_counter_ns()
        if torch._C._autograd._profiler_enabled():  # this thread is recorded
            self.native = torch.profiler.record_function(self.name)
            self.native.__enter__()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.native is not None:
            self.native.__exit__(*exc)
        _stack().pop()
        _BUFFER.append(Span(self.name, self.id, self.parent, threading.get_ident(),
                            self.start, end, self.attrs, self._device()))
        return False

    def _device(self):
        return None


class _Stage(_Open):
    __slots__ = ("events", "stream", "count", "count0")

    def __init__(self, name: str, attrs: dict, device: torch.device, count):
        super().__init__(name, attrs)
        self.events = None
        if device.type == "cuda":
            self.stream = torch.cuda.current_stream(device)
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
        self.count = count

    def __enter__(self):
        super().__enter__()
        self.count0 = self.count() if self.count is not None else None
        if self.events is not None:
            self.events[0].record(self.stream)
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record(self.stream)
        if self.count is not None:
            self.attrs["ops"] = self.count() - self.count0
        return super().__exit__(*exc)

    def _device(self):
        return HOST if self.events is None else self.events


def span(name: str, *, batch=None, req=None, n=None, h=None, w=None):
    """A context that records ``name`` around its block while a profiler
    runs; otherwise the shared no-op."""
    if not _profiler._is_profiler_enabled:
        return _NOOP
    return _Open(name, _attrs(batch, req, n, h, w))


def stage(name: str, device: torch.device, *, count: Optional[Callable[[], int]] = None,
          n=None, h=None, w=None):
    """``span`` that also carries the stage's device time on ``device``
    (the current stream there) and, with ``count``, its difference over the
    stage as ``ops``; otherwise the shared no-op."""
    if not _profiler._is_profiler_enabled:
        return _NOOP
    return _Stage(name, _attrs(None, None, n, h, w), device, count)


def device_ms(s: Span) -> Optional[float]:
    """A stage span's device time in ms (waiting for its end event), or
    None for a span that is no stage."""
    if s.device is None:
        return None
    if s.device == HOST:
        return (s.end_ns - s.start_ns) / 1e6
    start, end = s.device
    end.synchronize()
    return start.elapsed_time(end)


def record(name: str, start_ns: int, end_ns: int, *, batch=None, req=None, n=None, h=None,
           w=None) -> None:
    """Add a span whose ends the caller read (``time.perf_counter_ns``),
    under the span open on this thread, if any. Callers check ``enabled()``."""
    stack = _stack()
    _BUFFER.append(Span(name, next(_IDS), stack[-1] if stack else None, threading.get_ident(),
                        start_ns, end_ns, _attrs(batch, req, n, h, w)))


def spans() -> List[Span]:
    """The buffer's spans, oldest first (the newest ``BUFFER_SPANS``)."""
    return list(_BUFFER)


def clear() -> None:
    _BUFFER.clear()
