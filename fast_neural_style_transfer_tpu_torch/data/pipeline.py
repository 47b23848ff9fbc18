"""Host input pipeline: shuffle, batch, decode on threads, ship to the
card ``prefetch`` batches ahead (the JAX package's ``data/pipeline.py``).

Ordering is the JAX pipeline's: epoch e visits ``np.random.default_rng(seed
+ e).permutation(len(dataset))`` in batches, dropping the short tail
(``drop_last``) or filling it by wrapping around the permutation. The same
directory and seed give the same batches as there.

Transport: ``"u8"`` (the default) ships raw uint8, 4x fewer bytes than
float32, and the train step normalizes on the device; ``"f32"`` normalizes
on the host with the native kernel (``native.normalize_batch``, on
``min(num_workers, 8)`` threads) and ships network-space float32, bit for
bit the JAX pipeline's ``transport="f32"`` batches. The step takes either
(``train/step.py::normalize_u8_batch`` passes float batches through).

On the card a producer thread copies each batch from its own pinned host
buffer with ``non_blocking=True`` on a side stream and records an event
after the copy; up to ``prefetch`` batches wait in the queue (two by
default, as JAX's), and the consumer's stream waits on a batch's event
before using it. Each batch in flight has its own pinned buffer (PyTorch's
host allocator does not hand a pinned block out again until the copies
recorded on it have finished), its own device tensor and its own event,
and ``record_stream`` on the consumer's stream keeps the device tensor's
memory from being reused while work queued on it is pending.

Data parallelism: with ``num_data_shards`` > 1 the global batch is split
into that many contiguous slices and this rank decodes and ships only
slice ``shard_index`` (JAX's ``_local_slice`` at the rank's data index,
``local_batch_size`` images); the global batch must divide.

``pad_to_multiple`` > 0 pads each shard's slice up to that multiple by
repeating its last image (JAX's ``_pad_shards``); ``batch_mask`` (1 for
real rows, 0 for padding) is this shard's, which lets the step mask the
padding out of every loss exactly (``--pad_batch``), and
``batch_mask_global`` the shards' masks end to end, JAX's. The shards'
batches laid end to end are JAX's padded global batch.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Union

import numpy as np
import torch

from fast_neural_style_transfer_tpu_torch import native
from fast_neural_style_transfer_tpu_torch.data.dataset import ImageFolderDataset
from fast_neural_style_transfer_tpu_torch.utils import tracing

_SENTINEL = object()


class InputPipeline:
    def __init__(
        self,
        dataset: ImageFolderDataset,
        batch_size: int,
        *,
        seed: int = 0,
        num_workers: int = 8,
        prefetch: int = 2,
        drop_last: bool = True,
        transport: str = "u8",
        pad_to_multiple: int = 0,
        num_data_shards: int = 1,
        shard_index: int = 0,
        device: Union[str, torch.device] = "cuda",
    ):
        if transport not in ("u8", "f32"):
            raise ValueError(f"transport must be 'u8' or 'f32': {transport!r}")
        if prefetch < 1:
            # queue.Queue(maxsize=0) means UNBOUNDED: the producer would
            # ship the whole epoch ahead of the consumer
            raise ValueError(f"prefetch must be >= 1, got {prefetch}")
        if batch_size % num_data_shards:
            raise ValueError(f"global batch {batch_size} not divisible by "
                             f"{num_data_shards} data shards")
        if not 0 <= shard_index < num_data_shards:
            raise ValueError(f"shard_index {shard_index} outside [0, {num_data_shards})")
        if drop_last and len(dataset) < batch_size:
            raise ValueError(
                f"dataset has {len(dataset)} images but the batch is "
                f"{batch_size}; with drop_last=True every epoch would be "
                "empty. Lower --batch_size or pass drop_last=False "
                "(wrap-around fill).")
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.transport = transport
        self.device = torch.device(device)
        self.num_data_shards = num_data_shards
        self.shard_index = shard_index
        self.local_batch_size = batch_size // num_data_shards
        self.pad_to_multiple = int(pad_to_multiple)
        self.padded_size = self.local_batch_size  # this shard's rows, padding included
        self.batch_mask: Optional[np.ndarray] = None
        self.batch_mask_global: Optional[np.ndarray] = None
        if self.pad_to_multiple > 0:
            per = self.local_batch_size
            padded = -(-per // self.pad_to_multiple) * self.pad_to_multiple
            if padded != per:
                self.padded_size = padded
                mask = np.zeros((num_data_shards, padded), np.float32)
                mask[:, :per] = 1.0
                self.batch_mask_global = mask.reshape(-1)
                self.batch_mask = mask[shard_index].copy()

    # -- host-side batch assembly ------------------------------------------

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed + epoch)
        idx = rng.permutation(len(self.dataset))
        bs = self.batch_size
        if self.drop_last:
            idx = idx[: (len(idx) // bs) * bs]
        else:
            pad = -len(idx) % bs
            if pad:
                idx = np.resize(idx, len(idx) + pad)
        return idx.reshape(-1, bs)

    def _local_slice(self, batch_idx: np.ndarray) -> np.ndarray:
        per = self.local_batch_size
        return batch_idx[self.shard_index * per:(self.shard_index + 1) * per]

    def _make_batch(self, pool: ThreadPoolExecutor, batch_idx: np.ndarray) -> np.ndarray:
        u8 = np.stack(list(pool.map(self.dataset.__getitem__, self._local_slice(batch_idx))))
        if self.padded_size != self.local_batch_size:
            extra = np.repeat(u8[-1:], self.padded_size - self.local_batch_size, axis=0)
            u8 = np.concatenate([u8, extra], axis=0)
        if self.transport == "u8":
            return u8
        return native.normalize_batch(u8, n_threads=min(self.num_workers, 8))

    def host_batches(self, num_epochs: Optional[int] = None) -> Iterator[np.ndarray]:
        """This shard's (B, H, W, 3) numpy batches, epoch-shuffled: uint8,
        or network-space float32 with ``transport="f32"``."""
        with ThreadPoolExecutor(max_workers=self.num_workers,
                                thread_name_prefix="fnst-pipeline") as pool:
            epoch = 0
            while num_epochs is None or epoch < num_epochs:
                for batch_idx in self._epoch_indices(epoch):
                    yield self._make_batch(pool, batch_idx)
                epoch += 1

    # -- device prefetch ----------------------------------------------------

    def device_batches(self, num_epochs: Optional[int] = None) -> Iterator[torch.Tensor]:
        """``host_batches`` on ``device``, ``prefetch`` batches ahead. The
        consumer's wait for the next batch is the ``pipeline.wait`` span
        (``utils.tracing``)."""
        cuda = self.device.type == "cuda"
        copy_stream = torch.cuda.Stream(self.device) if cuda else None
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def to_device(hb: np.ndarray):
            t = torch.from_numpy(hb)
            if not cuda:
                return t.to(self.device), None
            with torch.cuda.stream(copy_stream):
                dev = t.pin_memory().to(self.device, non_blocking=True)
                ready = torch.cuda.Event()
                ready.record(copy_stream)
            return dev, ready

        def producer():
            try:
                for hb in self.host_batches(num_epochs):
                    if stop.is_set() or not put(to_device(hb)):
                        return
                put(_SENTINEL)
            except BaseException as e:  # surface worker failures to the consumer
                put(e)

        t = threading.Thread(target=producer, name="fnst-pipeline-producer", daemon=True)
        t.start()
        try:
            while True:
                with tracing.span("pipeline.wait"):
                    item = q.get()
                if item is _SENTINEL:
                    return
                if isinstance(item, BaseException):
                    raise item
                batch, ready = item
                if ready is not None:
                    stream = torch.cuda.current_stream(self.device)
                    stream.wait_event(ready)
                    batch.record_stream(stream)
                yield batch
        finally:
            stop.set()
            t.join(timeout=30)
