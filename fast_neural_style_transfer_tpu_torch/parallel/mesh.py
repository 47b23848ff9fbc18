"""Ranks, the (data, space) mesh and the launcher (the JAX package's
``parallel/mesh.py``) on ``torch.distributed``.

JAX runs one program over a mesh of devices, and ``shard_map`` hands each
shard its axis: its index, the axis size, ``ppermute`` and ``psum``. Here
the shards are processes (ranks), and an axis is a process group:
``SpaceAxis`` (one image's rows split over its ranks, ``ops/sharded.py``)
carries ``index``, ``size``, ``from_prev`` / ``from_next`` (the halo
exchange), ``psum`` and ``gather``; ``DataAxis`` (the batch split over its
ranks) carries ``index``, ``size``, ``all_reduce_``, ``psum`` and ``any``.

``make_mesh_plan(spatial=N)`` lays the ranks out as the JAX package's
``jax.make_mesh((world // N, N), ("data", "space"))`` lays out devices:
rank r has data index r // N and space index r % N, so a space group is N
contiguous ranks and a data group the ranks r % N == s. Every rank creates
every group, in the same order (``torch.distributed.new_group`` is
collective). Outside a process group, ``make_mesh_plan(devices=...)`` is a
``ReplicaPlan``: one process, a replica of the model on each device of a
list, a batch split over them in contiguous chunks (JAX's
``make_mesh_plan().batch_sharding`` for serving);
``place_on_data_axis`` keeps a batch whose leading dim does not divide
the data degree on one device.

The backend rule (``choose_backend``), stated and printed by ``launch``:
NCCL where every rank has a card of its own, gloo otherwise (the CPU; or
several ranks sharing one card). NCCL refuses two ranks on one card, and
gloo moves CUDA tensors only through ``broadcast``, ``all_reduce`` and
``barrier``. So ``SpaceAxis`` exchanges rows by one of two transports:
``"p2p"`` (``dist.batch_isend_irecv``: NCCL on CUDA tensors, gloo on CPU
tensors) or ``"mailbox"`` (gloo on CUDA tensors: each rank writes its rows
into its own slot of a zero-filled (size, rows...) buffer, one
``all_reduce`` sums the slots, and each rank reads the slot it wants; x + 0
is exact). ``transport="auto"`` picks by that rule; the CPU tests run both.

``launch(fn, nprocs, ...)`` spawns the ranks (``torch.multiprocessing``, a
``file://`` rendezvous in a temporary directory), calls ``fn(plan, *args)``
in each, and joins them with a deadline: a rank that fails or a deadline
that passes ends every rank and raises. Under ``torchrun`` it honours the
environment ``torchrun`` sets and runs ``fn`` in the calling process.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import shutil
import signal
import tempfile
import threading
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from fast_neural_style_transfer_tpu_torch.core.shapes import indexed_device, resolve_device

TRANSPORTS = ("auto", "p2p", "mailbox")

# the collectives' timeout in each rank: a rank that never reaches a
# collective ends the others' wait after this long, not PyTorch's 30 minutes
COLLECTIVE_TIMEOUT_S = 60.0


def _wire_dtype(backend: str, dtype: torch.dtype) -> torch.dtype:
    """The dtype a tensor crosses the wire in: gloo moves 16-bit floats as
    float32 (exact both ways)."""
    if backend == "gloo" and dtype in (torch.bfloat16, torch.float16):
        return torch.float32
    return dtype


class MeshAxis:
    """One process group seen as a mesh axis: this rank's ``index`` on it,
    its ``size``, and its collectives. ``group`` None is every rank;
    ``solo`` an axis of this rank alone (size 1, no collective).
    ``transport``: "auto", "p2p" or "mailbox" (module docstring)."""

    def __init__(self, group=None, transport: str = "auto", *, solo: bool = False):
        if transport not in TRANSPORTS:
            raise ValueError(f"transport {transport!r} is not one of {TRANSPORTS}")
        self.group = None if solo else group
        self.size = 1 if solo else dist.get_world_size(group)
        self.index = 0 if solo else dist.get_rank(group)
        self.backend = str(dist.get_backend(self.group))
        self.transport = transport

    def _mailbox(self, t: torch.Tensor, wire: torch.dtype) -> torch.Tensor:
        """(size, *t.shape): every rank's t, through one all_reduce of a
        zero-filled buffer in which each rank fills its own slot."""
        box = torch.zeros((self.size,) + tuple(t.shape), dtype=wire, device=t.device)
        box[self.index] = t.to(wire)
        dist.all_reduce(box, group=self.group)
        return box

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """(size, *t.shape): every rank's ``t``, exactly, on every rank, in
        rank order (no autograd), through the mailbox on every backend."""
        if self.size == 1:
            return t[None].clone()
        return self._mailbox(t, _wire_dtype(self.backend, t.dtype)).to(t.dtype)

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks in place (no autograd); every rank gets
        the same result."""
        if self.size > 1:
            wire = _wire_dtype(self.backend, t.dtype)
            if wire == t.dtype:
                dist.all_reduce(t, group=self.group)
            else:
                w = t.to(wire)
                dist.all_reduce(w, group=self.group)
                t.copy_(w)
        return t

    def any(self, flag: bool, device) -> bool:
        """True on every rank if ``flag`` is true on any."""
        t = torch.tensor([1.0 if flag else 0.0], device=device)
        return bool(self.all_reduce_(t).item() > 0)

    # autograd forms (ops/sharded.py's psum)
    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over the ranks for a value every rank then uses alike (a
        loss, a Gram matrix): its backward is the identity. Every rank
        backpropagates the same replicated loss, so each rank's share of
        the gradient is its own; the parameter gradients are summed once,
        at the end (``train/spatial_step.py``). An all_reduce backward
        (``torch.distributed.nn.functional.all_reduce``) would make every
        gradient size times too large."""
        return _PSum.apply(t, self)

    def psum_varying(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over the ranks for a value each rank then uses in its own way
        (a row written into one rank's slab): its backward sums the ranks'
        gradients."""
        return _PSumVarying.apply(t, self)


class SpaceAxis(MeshAxis):
    """The 'space' axis: ranks that split one image's rows, with the halo
    exchange."""

    def transport_for(self, t: torch.Tensor) -> str:
        """The transport the exchange of ``t`` takes."""
        if self.transport != "auto":
            return self.transport
        if self.backend == "gloo" and t.device.type == "cuda":
            return "mailbox"
        return "p2p"

    def _peer(self, index: int) -> int:
        """The global rank of this group's rank ``index``."""
        return dist.get_global_rank(self.group, index) if self.group is not None else index

    def shift(self, rows: torch.Tensor, offset: int) -> torch.Tensor:
        """Each rank receives the ``rows`` of rank (index - offset) mod size
        (a cyclic shift, every rank sending and receiving), no autograd.
        4-D rows come back channels_last, as the port keeps activations, so
        that joining them to a slab copies nothing more."""
        if self.size == 1:
            out = rows.clone()
        else:
            src = (self.index - offset) % self.size
            wire = _wire_dtype(self.backend, rows.dtype)
            if self.transport_for(rows) == "mailbox":
                out = self._mailbox(rows, wire)[src]
            else:
                send = rows.to(wire).contiguous()
                out = torch.empty_like(send)
                ops = [dist.P2POp(dist.isend, send,
                                  self._peer((self.index + offset) % self.size), self.group),
                       dist.P2POp(dist.irecv, out, self._peer(src), self.group)]
                for req in dist.batch_isend_irecv(ops):
                    req.wait()
        out = out.to(rows.dtype)
        return out.contiguous(memory_format=torch.channels_last) if out.dim() == 4 else out

    # autograd forms (ops/sharded.py's from_prev and from_next)
    def from_prev(self, rows: torch.Tensor) -> torch.Tensor:
        """Each rank receives ``rows`` from its previous (upper) neighbour,
        rank 0 from the last; the gradient goes back to the sender."""
        return _Shift.apply(rows, self, 1)

    def from_next(self, rows: torch.Tensor) -> torch.Tensor:
        """Each rank receives ``rows`` from its next (lower) neighbour, the
        last rank from rank 0; the gradient goes back to the sender."""
        return _Shift.apply(rows, self, -1)


class DataAxis(MeshAxis):
    """The 'data' axis: ranks that each hold their own samples of the
    batch. Its collectives are ``MeshAxis``'s: ``all_reduce_`` (the
    gradients' sum), ``psum`` (a loss term's sum over the batch) and
    ``any`` (a flag every rank must agree on)."""


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows, axis, offset):
        ctx.axis, ctx.offset = axis, offset
        return axis.shift(rows, offset)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.shift(g.contiguous(), -ctx.offset), None, None


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis):
        return axis.all_reduce_(t.clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _PSumVarying(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis):
        ctx.axis = axis
        return axis.all_reduce_(t.clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_reduce_(g.clone()), None


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """The ranks as a (data, space) mesh: this rank's axes, the group of
    every rank, and this rank's device."""

    space: SpaceAxis
    data: DataAxis
    world: MeshAxis
    device: torch.device

    @property
    def spatial(self) -> int:
        return self.space.size

    @property
    def backend(self) -> str:
        return self.world.backend

    @property
    def num_data_shards(self) -> int:
        return self.data.size

    @property
    def lead(self) -> bool:
        """Whether this is rank 0, the one that writes files and prints."""
        return self.world.index == 0

    def check_batch(self, global_batch_size: int) -> None:
        _check_batch(global_batch_size, self.num_data_shards)

    def describe(self, batch_size: int) -> str:
        """The JAX package's mesh line."""
        shape = {"data": self.data.size, "space": self.space.size}
        return (f"mesh: {shape} over {self.world.size} {self.device.type} device(s); "
                f"global batch {batch_size}")


@dataclasses.dataclass(frozen=True)
class ReplicaPlan:
    """One process, a replica of the model on each of ``devices`` (a device
    may repeat): the data axis of the serving paths. ``batch_sharding`` is
    the plan itself, what ``Stylizer(sharding=)`` and
    ``ArbitraryStylizer(sharding=)`` take, as they take JAX's
    ``make_mesh_plan().batch_sharding``."""

    devices: tuple

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    @property
    def num_data_shards(self) -> int:
        return len(self.devices)

    @property
    def batch_sharding(self) -> "ReplicaPlan":
        return self

    def check_batch(self, global_batch_size: int) -> None:
        _check_batch(global_batch_size, self.num_data_shards)

    def describe(self, batch_size: int) -> str:
        """The JAX package's mesh line."""
        return (f"mesh: {{'data': {self.num_data_shards}}} over {self.num_data_shards} "
                f"{self.device.type} device(s); global batch {batch_size}")


def _check_batch(global_batch_size: int, shards: int) -> None:
    if global_batch_size % shards:
        raise ValueError(f"global batch {global_batch_size} not divisible by "
                         f"data-parallel degree {shards}")


def place_on_data_axis(sharding: Optional[ReplicaPlan], batch: torch.Tensor) -> list:
    """``batch`` as the chunks its replicas run: contiguous equal chunks,
    the i-th on ``sharding.devices[i]``, when its leading dim divides the
    data degree; otherwise the whole batch on the first device (single
    images and ragged tails must not fail a data-parallel server). None:
    [batch]. Every serving path places batches through this, so the rule
    cannot diverge."""
    if sharding is None:
        return [batch]
    n = sharding.num_data_shards
    if batch.shape[0] % n:
        return [batch.to(sharding.device)]
    return [c.to(d) for c, d in zip(batch.chunk(n), sharding.devices)]


def _replica_devices(device) -> tuple:
    """The devices of a ``ReplicaPlan`` for ``device``: every visible card
    for None or "cuda" (no card raises), else that one device."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))
    return (indexed_device(dev),)


def _axis(groups: List[List[int]], cls, transport: str):
    """This rank's axis among ``groups`` (a partition of the ranks): the
    default group when one group holds every rank, a solo axis when each
    holds one, else its own new group (every rank creates every group, in
    the same order)."""
    if len(groups) == 1:
        return cls(None, transport)
    if len(groups[0]) == 1:
        return cls(None, transport, solo=True)
    rank, mine = dist.get_rank(), None
    for ranks in groups:
        group = dist.new_group(ranks)
        if rank in ranks:
            mine = group
    return cls(mine, transport)


def make_mesh_plan(spatial: int = 1, *, device=None, transport: str = "auto",
                   devices: Optional[Sequence] = None):
    """The mesh over the initialized process group's ranks -> ``MeshPlan``:
    ``spatial`` ranks split an image's rows, the world // spatial space
    groups split the batch (the data axis). ``device``: this rank's device
    (None: its card, the current CUDA device; no card raises, as
    ``core/shapes.py::resolve_device`` does).

    ``devices`` (a list), or no process group: a one-process
    ``ReplicaPlan`` over ``devices``, by default over every visible card
    (``device`` None or "cuda"; no card raises) or over ``device``."""
    if devices is not None or not dist.is_initialized():
        if spatial != 1:
            raise RuntimeError("a 'space' axis needs an initialized process group "
                               "(parallel.launch, or torchrun)")
        devs = (tuple(indexed_device(resolve_device(d)) for d in devices)
                if devices is not None else _replica_devices(device))
        if not devs:
            raise ValueError("a replica plan needs at least one device")
        return ReplicaPlan(devs)
    world = dist.get_world_size()
    if spatial < 1 or world % spatial:
        raise ValueError(f"{world} ranks not divisible by spatial={spatial}")
    device = indexed_device(resolve_device(device))
    data = world // spatial
    space = _axis([list(range(d * spatial, (d + 1) * spatial)) for d in range(data)],
                  SpaceAxis, transport)
    data_axis = _axis([list(range(s, world, spatial)) for s in range(spatial)],
                      DataAxis, transport)
    return MeshPlan(space=space, data=data_axis, world=MeshAxis(None, transport),
                    device=device)


def choose_backend(device: str, nprocs: int) -> tuple:
    """(backend, reason): NCCL where every rank has a card of its own, gloo
    otherwise."""
    if torch.device(device).type != "cuda":
        return "gloo", "CPU ranks"
    cards = torch.cuda.device_count()
    if cards >= nprocs:
        return "nccl", f"{nprocs} ranks, one card each ({cards} cards)"
    return "gloo", (f"{nprocs} ranks share {cards} card(s): NCCL refuses two "
                    "ranks on one card")


def _under_torchrun() -> bool:
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"))


def _rank_device(device: str, backend: str, local_rank: int) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    index = local_rank % max(torch.cuda.device_count(), 1)
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def kernel_counts() -> dict:
    """This process's kernel launch counts (the wrappers' ``launches``
    counters, in all and by route, affine and mode), for the kernels whose
    modules it loaded (``ops/_build.py::COUNTED``)."""
    from fast_neural_style_transfer_tpu_torch.ops._build import COUNTED

    return {fn.__name__: {name: dict(v) if isinstance(v, dict) else v
                          for name, v in vars(fn).items() if name.startswith("launches")}
            for fn in COUNTED}


def _rank_main(rank: int, nprocs: int, spatial: int, fn, args, backend: str,
               device: str, transport: str, tmp: str) -> None:
    """One spawned rank: join the group, call fn(plan, *args), save its
    result and its kernel launch counts (or its traceback) for the
    parent."""
    try:
        if torch.device(device).type == "cpu":
            torch.set_num_threads(1)
        dev = _rank_device(device, backend, rank)
        dist.init_process_group(
            backend, init_method="file://" + os.path.join(tmp, "rendezvous"),
            rank=rank, world_size=nprocs,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S),
            **({"device_id": dev} if backend == "nccl" else {}))
        try:
            plan = make_mesh_plan(spatial, device=dev, transport=transport)
            out = fn(plan, *args)
            torch.save({"result": out, "kernel_counts": kernel_counts()},
                       os.path.join(tmp, f"result_{rank}.pt"))
        finally:
            dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(tmp, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)


def prebuild_kernels() -> None:
    """Build the CUDA sources the ranks load once, in the calling process,
    before ranks that would each build them start (``ops/_build.py``
    caches by hash)."""
    from fast_neural_style_transfer_tpu_torch.ops import _build

    for name in _build.TOGETHER:
        _build.build(name)


def launch(fn: Callable, nprocs: int, args: Sequence[Any] = (), *,
           spatial: Optional[int] = None, device=None, backend: Optional[str] = None,
           transport: str = "auto", deadline_s: float = 600.0,
           quiet: bool = False) -> List[Any]:
    """Run ``fn(plan, *args)`` on ``nprocs`` ranks over ``device`` (None or
    "cuda": the cards, and no card raises; "cpu" only when asked) -> each
    rank's return value (loaded onto the CPU), in rank order. ``plan`` is
    ``make_mesh_plan(spatial)``; ``spatial`` None puts every rank on the
    'space' axis (a data degree of 1).

    ``backend``: None picks by ``choose_backend`` (printed). The ranks are
    spawned processes (``fn`` and its arguments must pickle; the kernels
    are built here first); a rank that raises, or the deadline passing,
    terminates every rank and raises here. ``launch.kernel_counts`` then
    holds each rank's ``kernel_counts()`` as ``fn`` left them (each rank
    starts at 0). A SIGTERM to this process while its ranks run (a
    preemption; the handler is installed from the main thread only) is
    passed on to every live rank, and the ranks are waited for: a trainer's
    ranks checkpoint and return. Under ``torchrun`` the process group comes
    from its environment and ``fn`` runs here, on this rank only: -> [its
    return value]."""
    device = resolve_device(device).type
    spatial = nprocs if spatial is None else spatial
    if _under_torchrun():
        if not dist.is_initialized():
            local = int(os.environ.get("LOCAL_RANK", 0))
            be = backend or choose_backend(device, int(os.environ["WORLD_SIZE"]))[0]
            dev = _rank_device(device, be, local)
            dist.init_process_group(
                be, timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        else:
            dev = _rank_device(device, dist.get_backend(), int(os.environ.get("LOCAL_RANK", 0)))
        out = fn(make_mesh_plan(spatial, device=dev, transport=transport), *args)
        launch.kernel_counts = [kernel_counts()]
        return [out]
    reason = "given"
    if backend is None:
        backend, reason = choose_backend(device, nprocs)
    if not quiet:
        print(f"launch: {nprocs} ranks on {device}, backend {backend} ({reason})",
              flush=True)
    if torch.device(device).type == "cuda":
        prebuild_kernels()
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="fnst_ranks_")
    procs = []
    terminated = threading.Event()

    def _pass_on(signum, frame):
        if not quiet:
            print(f"launch: SIGTERM passed on to {nprocs} ranks", flush=True)
        terminated.set()
        for p in procs:
            if p.is_alive():
                p.terminate()

    prev_handler = None
    on_main = threading.current_thread() is threading.main_thread()
    if on_main:
        prev_handler = signal.signal(signal.SIGTERM, _pass_on)
    try:
        for rank in range(nprocs):
            p = ctx.Process(target=_rank_main, args=(rank, nprocs, spatial, fn, tuple(args),
                                                     backend, device, transport, tmp),
                            daemon=True)
            p.start()
            procs.append(p)
            if terminated.is_set():  # the signal came while the ranks started
                p.terminate()
        end = time.monotonic() + deadline_s
        while any(p.is_alive() for p in procs):
            failed = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
            if failed or time.monotonic() > end:
                break
            time.sleep(0.05)
        timed_out = not any(p.exitcode not in (None, 0) for p in procs) and any(
            p.is_alive() for p in procs)
        if not timed_out:  # a failure: the others end on their own, or soon
            grace = time.monotonic() + 5.0
            for p in procs:
                p.join(max(grace - time.monotonic(), 0.0))
        failed = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
        if failed or timed_out:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(10)
            if timed_out:
                raise TimeoutError(f"{nprocs} ranks did not finish within {deadline_s} s")
            errors = []
            for r in failed:
                path = os.path.join(tmp, f"error_{r}.txt")
                text = open(path).read() if os.path.exists(path) else "(no traceback)"
                errors.append(f"rank {r} (exit {procs[r].exitcode}):\n{text}")
            raise RuntimeError("a rank failed:\n" + "\n".join(errors))
        for p in procs:
            p.join()
        saved = [torch.load(os.path.join(tmp, f"result_{r}.pt"), map_location="cpu",
                            weights_only=False) for r in range(nprocs)]
        launch.kernel_counts = [s["kernel_counts"] for s in saved]
        return [s["result"] for s in saved]
    finally:
        if on_main:
            signal.signal(signal.SIGTERM, prev_handler or signal.SIG_DFL)
        for p in procs:
            if p.is_alive():
                p.kill()
        shutil.rmtree(tmp, ignore_errors=True)


# each rank's kernel launch counts after the last spawned launch, or None
launch.kernel_counts = None
