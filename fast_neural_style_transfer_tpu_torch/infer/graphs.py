"""CUDA graphs of the serving forward: the u8 -> u8 device program between
copy in and copy out, captured for an input key that comes back and
replayed after that.

A stylizer that opts in (``engages``: a CUDA device, no multi-device
replica plan, a precision other than int8) holds one ``ForwardGraphs`` and
hands it to ``infer/stylize.py::serve_u8``. The key is the batch's (rows,
height, width) as ``serve_u8`` receives it, plus what the stylizer adds
(AdaIN's ``alpha``), under the process's convolution algorithm settings
(cuDNN's deterministic, benchmark and TF32 flags). A key's first call runs
eagerly and is only noted, so a key met once (one file, a bulk job's
one-off photo size) costs nothing more. Its second call runs eagerly and
answers; its input tensor then becomes the key's static input and the
program (bucket pad, ``u8_to_network``, the network, ``network_to_u8``) is
captured on the calling thread. A later call copies into that input,
replays and reads the static outputs. A replay runs the kernels of the
capture, on the same shapes and plans, so it gives the eager call's bits.

At most ``MAX_GRAPHS`` graphs are kept. A new key takes the place of the
least recently used graph only if that one was not replayed in the last
``STALE_CALLS`` calls; otherwise it stays eager. So a caller that cycles
through more keys than are kept replays those it holds and runs the others
eagerly, with no capture on every call, and a graph is captured at most
once every ``STALE_CALLS`` calls once all are held.

Memory: a stylizer's graphs share one private pool (a new one once none
is kept), so a capture may reuse what another graph's intermediates left
free. That is safe because one call at a time replays (``lock``, held from
copy in to copy out) and its outputs are on the host before the next
replay. The pool holds about one forward's working set beside the eager
path's, plus every graph's static outputs. A capture runs on a side stream
of the stylizer's own and costs about one eager enqueue and the graph's
instantiation.

Launch counters (every kernel wrapper's in ``ops/_build.py::COUNTED``)
count the kernels that ran: a capture's own increments are taken back, and
each replay adds them again. ``captures``, ``replays`` and ``evictions``
count the cache's own events.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Dict, Hashable, List, Optional, Tuple

import torch

from fast_neural_style_transfer_tpu_torch.ops._build import COUNTED

# the serving warm-up's keys (batch rows 1..8) at two buckets
MAX_GRAPHS = 16
# calls after which an unused graph may give way to a new key; also the
# number of keys noted as seen once
STALE_CALLS = 1024


def engages(device: torch.device, *, sharding=None, int8: bool = False) -> bool:
    """Whether a stylizer serves through graphs: only on a CUDA device, with
    no replica plan over several devices, and not int8 (its forward's
    dynamic scales)."""
    return (device.type == "cuda"
            and (sharding is None or sharding.num_data_shards == 1)
            and not int8)


def launch_counts() -> Dict[tuple, int]:
    """Every kernel wrapper's launch counter: (wrapper, attribute, key) ->
    count, key None for a total, else the entry of a ``launches_by_*``
    dict."""
    out = {}
    for fn in COUNTED:
        for name, value in vars(fn).items():
            if not name.startswith("launches"):
                continue
            if isinstance(value, dict):
                out.update(((fn, name, k), v) for k, v in value.items())
            else:
                out[(fn, name, None)] = value
    return out


def add_launch_counts(counts: Dict[tuple, int], sign: int = 1) -> None:
    """Add ``sign`` times ``counts`` (as ``launch_counts`` keys them) to the
    wrappers' counters."""
    for (fn, name, key), n in counts.items():
        if key is None:
            setattr(fn, name, getattr(fn, name) + sign * n)
        else:
            getattr(fn, name)[key] += sign * n


def _algorithm_settings() -> tuple:
    """The process's settings that choose the forward's convolution kernels:
    a graph replays the kernels chosen at its capture, so each setting
    keeps graphs of its own."""
    cudnn = torch.backends.cudnn
    return (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32, torch.are_deterministic_algorithms_enabled())


@dataclass
class _Graph:
    graph: object  # has replay()
    x: torch.Tensor  # the static input
    outs: List[torch.Tensor]  # the static outputs
    counts: Dict[tuple, int]  # the launch counters one forward adds
    last: int  # the call that last used it


Capture = Callable[[torch.Tensor, Callable], Tuple[object, List[torch.Tensor]]]


class ForwardGraphs:
    """A stylizer's graphs, by key, least recently used first. ``capture``
    (tests' stand-in) maps (x, program) to (an object with ``replay()``,
    program's static outputs); by default a CUDA graph in the shared pool."""

    def __init__(self, capture: Optional[Capture] = None):
        self.lock = threading.Lock()
        self._entries: "OrderedDict[Hashable, _Graph]" = OrderedDict()
        self._seen: "OrderedDict[Hashable, None]" = OrderedDict()  # keys noted, no graph
        self._calls = 0
        self._capture = capture or self._cuda_graph
        self._pool = self._stream = None
        self.captures = self.replays = self.evictions = 0

    def keys(self) -> list:
        """The keys of the graphs kept, least recently used first."""
        return [key for key, _ in self._entries]

    def get(self, key: Hashable) -> Optional[_Graph]:
        """A call of ``key``: its graph under the current algorithm
        settings, now the most recently used, or None."""
        self._calls += 1
        key = (key, _algorithm_settings())
        entry = self._entries.get(key)
        if entry is not None:
            entry.last = self._calls
            self._entries.move_to_end(key)
        return entry

    def admits(self, key: Hashable) -> bool:
        """After a call of ``key`` found no graph: whether to capture it now.
        A first sighting is only noted. A later one is captured where a
        graph is free: fewer than ``MAX_GRAPHS`` are kept, or the least
        recently used has gone unused for ``STALE_CALLS`` calls (it is
        evicted)."""
        key = (key, _algorithm_settings())
        if key not in self._seen:
            self._seen[key] = None
            if len(self._seen) > STALE_CALLS:
                self._seen.popitem(last=False)
            return False
        self._seen.move_to_end(key)
        if len(self._entries) >= MAX_GRAPHS:
            oldest, entry = next(iter(self._entries.items()))
            if self._calls - entry.last < STALE_CALLS:
                return False
            del self._entries[oldest]
            self.evictions += 1
        return True

    def capture(self, key: Hashable, x: torch.Tensor, program: Callable) -> None:
        """Capture ``program(x)`` as ``key``'s graph, x its static input, and
        take the capture's counter increments back (no kernel ran)."""
        before = launch_counts()
        try:
            graph, outs = self._capture(x, program)
        finally:
            counts = {k: n - before.get(k, 0) for k, n in launch_counts().items()
                      if n != before.get(k, 0)}
            add_launch_counts(counts, -1)
        self._entries[key, _algorithm_settings()] = _Graph(graph, x, list(outs), counts,
                                                           self._calls)
        self.captures += 1

    def replay(self, entry: _Graph) -> List[torch.Tensor]:
        """Replay ``entry`` (its input already copied in) -> its static
        outputs, valid until the next replay."""
        entry.graph.replay()
        add_launch_counts(entry.counts)
        self.replays += 1
        return entry.outs

    def clear(self) -> None:
        """Drop every graph (what they read changed, as a new style)."""
        with self.lock:
            self._entries.clear()

    def _cuda_graph(self, x: torch.Tensor, program: Callable):
        """Capture on a side stream of the stylizer's own, after the work
        the caller's stream holds. Unlike ``torch.cuda.graph`` this neither
        synchronizes nor empties the allocator's cache, whose blocks the
        eager calls of other keys would otherwise allocate anew."""
        device = x.device
        with torch.cuda.device(device):
            if self._stream is None:
                self._stream = torch.cuda.Stream(device)
            if not self._entries:  # the allocator frees a pool that no graph holds
                self._pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            self._stream.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(self._stream):
                graph.capture_begin(pool=self._pool, capture_error_mode="thread_local")
                try:
                    outs = program(x)
                finally:
                    graph.capture_end()
            torch.cuda.current_stream(device).wait_stream(self._stream)
        return graph, outs


class GraphCounts:
    """The always-on counters of a stylizer's ``_graphs`` (None: it serves
    eagerly, and every count is 0)."""

    _graphs: Optional[ForwardGraphs] = None

    @property
    def graph_captures(self) -> int:
        return self._graphs.captures if self._graphs is not None else 0

    @property
    def graph_replays(self) -> int:
        return self._graphs.replays if self._graphs is not None else 0

    @property
    def graph_evictions(self) -> int:
        return self._graphs.evictions if self._graphs is not None else 0
