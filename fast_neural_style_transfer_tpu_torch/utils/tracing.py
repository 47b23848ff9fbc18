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
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import deque
from typing import Deque, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _profiler

__all__ = ["Span", "clear", "enabled", "record", "span", "spans"]

BUFFER_SPANS = 1 << 17


class Span(NamedTuple):
    name: str
    id: int
    parent: Optional[int]  # the enclosing span on the same thread
    thread: int
    start_ns: int  # time.perf_counter_ns()
    end_ns: int
    attrs: dict


_BUFFER: Deque[Span] = deque(maxlen=BUFFER_SPANS)
_IDS = itertools.count(1)
_LOCAL = threading.local()
_NOOP = contextlib.nullcontext()


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
                            self.start, end, self.attrs))
        return False


def span(name: str, *, batch=None, req=None, n=None, h=None, w=None):
    """A context that records ``name`` around its block while a profiler
    runs; otherwise the shared no-op."""
    if not _profiler._is_profiler_enabled:
        return _NOOP
    return _Open(name, _attrs(batch, req, n, h, w))


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
