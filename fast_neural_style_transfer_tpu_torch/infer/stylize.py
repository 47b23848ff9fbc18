"""Inference: arbitrary-resolution stylization on the card.

Input is ImageNet-normalized; inputs are reflect-padded up to a shape
bucket (a multiple of 64 by default) and the output is cropped back, so
mixed sizes share a bounded set of shapes. The production path is uint8 in
and uint8 out, with normalization, forward and de-normalization all on the
device, so host and device exchange uint8 both ways.

Data parallelism (``Stylizer(sharding=plan)``, ``plan`` a
``parallel.ReplicaPlan``): a replica of the params on each device of the
plan; a batch whose leading dim divides the plan's degree runs as
contiguous chunks, each on its device, the outputs gathered in order; any
other batch runs on the first device (``parallel.place_on_data_axis``).
"""

from __future__ import annotations

import contextlib
import copy
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from fast_neural_style_transfer_tpu_torch.core.dtypes import canonical_compute_dtype, exact_f32
from fast_neural_style_transfer_tpu_torch.core.shapes import (
    indexed_device,
    pad_to_multiple_reflect,
    resolve_device,
)
from fast_neural_style_transfer_tpu_torch.infer.graphs import ForwardGraphs, GraphCounts, engages
from fast_neural_style_transfer_tpu_torch.infer.quantized import (
    apply_int8_replicas,
    quantize_params,
    to_device,
)
from fast_neural_style_transfer_tpu_torch.models.transformer import (
    TransformerNet,
    bake_style,
    num_styles,
    require_single_style,
)
from fast_neural_style_transfer_tpu_torch.models.weights import load_checkpoint
from fast_neural_style_transfer_tpu_torch.parallel.mesh import make_mesh_plan, place_on_data_axis
from fast_neural_style_transfer_tpu_torch.utils import tracing
from fast_neural_style_transfer_tpu_torch.utils.color import luminance_transfer
from fast_neural_style_transfer_tpu_torch.utils.image_io import (
    decode_image,
    denormalize_image,
    mean_std,
    network_to_u8,
    resize_image,
    scan_image_files,
    u8_to_network,
    u8_to_unit,
)


def serve_u8(image_u8, device: torch.device, bucket_multiple: int, launch,
             graphs: Optional[ForwardGraphs] = None, key: tuple = ()) -> np.ndarray:
    """The uint8 round trip every stylizer serves by: raw uint8
    (H,W,3)/(N,H,W,3) in, copied to ``device``, reflect-padded up to a
    multiple of ``bucket_multiple``; ``launch(padded)`` -> the uint8 NHWC
    outputs of its chunks, in order; cropped back and copied out (joined on
    the host only when there are several). Spans
    (``utils.tracing``): ``stylize.copy_in``, ``stylize.launch`` (pad,
    network, u8 out enqueued) and ``stylize.copy_out`` (waits for the
    device).

    ``graphs`` (``infer/graphs.py``): the device program from the pad to
    the u8 out is a CUDA graph per (rows, height, width) + ``key``. A key's
    first call runs eagerly; its second runs eagerly, then is captured (a
    one-time cost of about one more enqueue and the graph's instantiation,
    paid by that call; the graphs' shared pool holds about one more
    forward's working set); a captured key copies into its static input
    and replays, inside ``stylize.launch``, as a ``stylize.replay`` span."""
    image_u8 = np.asarray(image_u8)
    if image_u8.dtype != np.uint8:
        raise TypeError(f"stylize_u8 wants uint8, got {image_u8.dtype}")
    squeeze = image_u8.ndim == 3
    batch = image_u8[None] if squeeze else image_u8
    n, hh, ww = batch.shape[:3]
    key = (n, hh, ww) + tuple(key)

    def program(x):
        return launch(pad_to_multiple_reflect(x, bucket_multiple)[0])

    with graphs.lock if graphs is not None else contextlib.nullcontext():
        graph = graphs.get(key) if graphs is not None else None
        with tracing.span("stylize.copy_in", n=n, h=hh, w=ww):
            # straight from the caller's buffer (copied only if it is not C
            # contiguous or not writable): the copy to the device completes
            # before this returns, so the buffer is free again afterwards
            src = torch.from_numpy(np.require(batch, requirements=("C", "W")))
            if graph is not None:
                x = graph.x.copy_(src)
            else:  # a tensor of its own where it may become a static input
                x = src.to(device, copy=graphs is not None)
        with tracing.span("stylize.launch", n=n, h=hh, w=ww):
            if graph is None:
                outs = program(x)
            else:
                with tracing.span("stylize.replay", n=n, h=hh, w=ww):
                    outs = graphs.replay(graph)
        with tracing.span("stylize.copy_out", n=n, h=hh, w=ww):
            outs = [o[:, :hh, :ww, :].cpu() for o in outs]
            out = (outs[0] if len(outs) == 1 else torch.cat(outs)).numpy()
        if graph is None and graphs is not None and graphs.admits(key):
            graphs.capture(key, x, program)
    return out[0] if squeeze else out


class Stylizer(GraphCounts):
    """A stylizer network on one device, with the u8 and network-space APIs.

    ``params``: a single-style reference-layout state_dict (``load_params``,
    ``models.weights.params_from_jax``, ``TransformerNet().state_dict()``);
    ``from_checkpoint(style=...)`` bakes a multi-style one.
    ``device``: ``None`` means the card ("cuda"); with no card that raises.
    Pass ``device="cpu"`` to run on the CPU.
    ``precision``: "f32" or "bf16" compute; parameters stay float32 and IN
    statistics are float32. On the card, "f32" means real float32: the
    constructor turns TF32 off for cuDNN convolutions and for matmuls
    (``core/dtypes.py::exact_f32``, process-wide settings).
    "int8": the conv weights are quantized once, here (after any
    ``bake_style``), and every forward runs ``infer/quantized.py::
    apply_int8_replicas`` (the batch as one chunk, or its chunks on the
    replicas) with dynamic activation scales; the rest is float32 as
    above. Its output depends on the batch an image shares (one activation
    scale a tensor).
    ``preserve_color="luma"``: keep the stylized luminance and the
    content's chrominance (u8 path only).
    ``sharding``: a ``ReplicaPlan`` (``make_mesh_plan(devices=...)
    .batch_sharding``): the params are replicated on its devices (the
    first one is ``device``) and a batch whose leading dim divides its
    degree runs split over them. An int8 batch so split shares each
    conv's dynamic scale over the chunks: the whole batch's max, as an
    unsplit call takes it. The split still moves outputs in their last
    bits where the IN kernel's plan follows the batch size (a sample's
    statistics sum in another order at N=4 than at N=8), which int8's
    requantization amplifies: on the card two chunks of a B=8 batch moved
    int8 outputs by up to 18 levels (16 with every scale held equal) and
    f32 by one (``chip_smoke.py``, phase ``data_parallel_serving``).

    ``stylize_u8`` on a card, unsharded (or a one-device plan) and not
    int8 replays a CUDA graph of its device program per (rows, height,
    width) (``infer/graphs.py``): a key that comes back costs one capture,
    about one more enqueue and the graph's instantiation, on its second
    call, and the graphs' shared pool holds about one more forward's
    working set. ``graph_captures``, ``graph_replays`` and
    ``graph_evictions`` count them. Every other path runs eagerly.
    """

    def __init__(
        self,
        params: Mapping[str, Any],
        *,
        precision: str = "f32",
        bucket_multiple: int = 64,
        preserve_color: str = "off",
        device: Optional[Union[str, torch.device]] = None,
        sharding: Optional[Any] = None,
    ):
        if preserve_color not in ("off", "luma"):
            raise ValueError(
                f"preserve_color must be 'off' or 'luma' (got "
                f"{preserve_color!r})")
        if sharding is not None and device is not None and (
                indexed_device(resolve_device(device)) != sharding.device):
            raise ValueError(f"device {device} is not the plan's first device "
                             f"{sharding.device}")
        self.sharding = sharding
        self.device = indexed_device(
            resolve_device(device if sharding is None else sharding.device))
        self.preserve_color = preserve_color
        self.bucket_multiple = bucket_multiple
        require_single_style(params, "Stylizer")
        self.net: Optional[TransformerNet] = None
        self.qparams: Optional[Dict[str, Any]] = None
        if precision == "int8":
            self.precision = canonical_compute_dtype("f32")  # the non-conv math
            self.qparams = to_device(quantize_params(params), self.device)
        else:
            self.precision = canonical_compute_dtype(precision)
            net = TransformerNet()
            net.load_state_dict(params, strict=True)
            self.net = net.eval().to(self.device, memory_format=torch.channels_last)
        exact_f32(self.device, self.precision)
        # the net (or quantized tree) on each other device of the plan
        own = self.qparams if self.qparams is not None else self.net
        self._replicas: Dict[torch.device, Any] = {
            d: to_device(own, d) if self.qparams is not None else copy.deepcopy(own).to(d)
            for d in (sharding.devices if sharding is not None else ())
            if d != self.device}
        if engages(self.device, sharding=sharding, int8=self.qparams is not None):
            self._graphs = ForwardGraphs()

    # -- constructors -------------------------------------------------------

    @staticmethod
    def load_params(path: str) -> Dict[str, torch.Tensor]:
        """Reference-layout state_dict from a ``.pth`` or a JAX ``.npz``;
        a multi-style checkpoint keeps its (S, C) IN banks."""
        return load_checkpoint(path)

    @classmethod
    def from_checkpoint(cls, path: str, *, style=None, **kw) -> "Stylizer":
        """Load a checkpoint and build a Stylizer; ``style`` as for
        ``load_style_params``."""
        return cls(load_style_params(path, style), **kw)

    # -- forward ------------------------------------------------------------

    def _model(self, device: torch.device):
        """The net (or quantized tree) on ``device``: this Stylizer's own on
        its device, elsewhere the replica made in ``__init__``."""
        if device == self.device:
            return self.qparams if self.qparams is not None else self.net
        return self._replicas[device]

    def _forward(self, chunks: list) -> list:
        """Each chunk (network space, on its device) through its replica;
        every forward is launched before any output is read."""
        models = [self._model(c.device) for c in chunks]
        if self.qparams is not None:
            return apply_int8_replicas(models, chunks)
        return [m(c, self.precision) for m, c in zip(models, chunks)]

    def _u8_roundtrip(self, chunks: list) -> list:
        """uint8 NHWC chunks in -> uint8 out, entirely on their devices."""
        ys = self._forward([u8_to_network(c) for c in chunks])
        if self.preserve_color != "luma":
            return [network_to_u8(y) for y in ys]
        out = []
        for y, x_u8 in zip(ys, chunks):
            mean, std = mean_std(y.device)
            y01 = luminance_transfer(torch.clamp(y * std + mean, 0.0, 1.0),
                                     u8_to_unit(x_u8))
            out.append(torch.clamp(torch.round(y01 * 255.0), 0, 255).to(torch.uint8))
        return out

    def _chunks(self, padded: torch.Tensor) -> list:
        return place_on_data_axis(self.sharding, padded)

    @torch.inference_mode()
    def __call__(self, batch: np.ndarray) -> np.ndarray:
        """Network-space NHWC in -> network-space NHWC out (same H, W)."""
        x = torch.as_tensor(np.asarray(batch, np.float32), device=self.device)
        padded, (h, w) = pad_to_multiple_reflect(x, self.bucket_multiple)
        outs = self._forward(self._chunks(padded))
        return torch.cat([o[:, :h, :w, :].float().cpu() for o in outs]).numpy()

    def stylize(self, image: np.ndarray) -> np.ndarray:
        """Network-space (H,W,3)/(N,H,W,3) float in -> [0,1] stylized out."""
        if image.ndim == 3:
            return self.stylize(image[None])[0]
        return denormalize_image(self(image))

    @torch.inference_mode()
    def stylize_u8(self, image_u8: np.ndarray) -> np.ndarray:
        """Raw uint8 (H,W,3)/(N,H,W,3) in -> stylized uint8 out, by
        ``serve_u8`` (its spans; replayed as a graph where one is kept)."""
        return serve_u8(image_u8, self.device, self.bucket_multiple,
                        lambda x: self._u8_roundtrip(self._chunks(x)), self._graphs)

    @torch.inference_mode()
    def raw_forward_u8(self, x_u8: torch.Tensor) -> torch.Tensor:
        """Benchmarking hook: the u8 -> u8 device program at an already
        bucket-aligned shape; input and output stay device tensors."""
        if x_u8.ndim != 4 or x_u8.dtype != torch.uint8:
            raise TypeError("raw_forward_u8 wants a uint8 NHWC batch")
        h, w = int(x_u8.shape[1]), int(x_u8.shape[2])
        if h % self.bucket_multiple or w % self.bucket_multiple:
            raise ValueError(
                f"raw_forward_u8 needs bucket-aligned H/W (multiple of "
                f"{self.bucket_multiple}); got {h}x{w} — use stylize_u8 for "
                "arbitrary sizes")
        outs = self._u8_roundtrip(self._chunks(x_u8.to(self.device)))
        return torch.cat([o.to(self.device) for o in outs]) if len(outs) > 1 else outs[0]


def load_style_params(path: str, style=None) -> Dict[str, torch.Tensor]:
    """A checkpoint's single-style state_dict. ``style``: an int style
    index or a length-S convex blend, baked into single-style params
    (``bake_style``); required for a multi-style checkpoint, refused for a
    single-style one."""
    params = load_checkpoint(path)
    s = num_styles(params)
    if s > 1:
        if style is None:
            raise ValueError(
                f"{path} is a {s}-style checkpoint: pass style=<index "
                f"0..{s - 1}> or a length-{s} blend-weight vector")
        return bake_style(params, style)
    if style is not None:
        raise ValueError(
            f"style={style!r} given but {path} is a single-style checkpoint")
    return params


def stylize_image_file(
    model_path: str,
    content_path: str,
    output_path: str,
    *,
    size: Optional[Tuple[int, int]] = None,
    precision: str = "f32",
    style=None,
    preserve_color: str = "off",
    device: Optional[Union[str, torch.device]] = None,
) -> str:
    """File in, file out, through the uint8 device roundtrip. ``style``:
    index or blend for a multi-style checkpoint (``from_checkpoint``)."""
    from PIL import Image

    stylizer = Stylizer.from_checkpoint(model_path, precision=precision,
                                        style=style, device=device,
                                        preserve_color=preserve_color or "off")
    u8 = decode_image(content_path)
    if size is not None:
        u8 = resize_image(u8, size)
    Image.fromarray(stylizer.stylize_u8(u8)).save(output_path)
    return output_path


def stylize_directory(
    model_path: str,
    content_dir: str,
    output_dir: str,
    *,
    size: Optional[Tuple[int, int]] = None,
    batch_size: int = 16,
    precision: str = "f32",
    num_workers: int = 8,
    data_parallel: bool = False,
    style=None,
    skip_bad_images: bool = False,
    preserve_color: str = "off",
    device: Optional[Union[str, torch.device]] = None,
) -> list:
    """Stylize every image under ``content_dir`` into ``output_dir``,
    mirroring relative paths as ``<relpath>_stylized.jpg``; ``style`` as
    for ``stylize_image_file``. Returns the written paths (``None`` where a
    bad image was skipped). ``data_parallel``: split each batch over every
    visible card (``device`` None or "cuda"; else the one device
    ``device``), a replica on each; ``batch_size`` must divide by their
    number."""
    files = scan_image_files(content_dir)
    sharding = None
    if data_parallel:
        plan = make_mesh_plan(device=device)
        plan.check_batch(batch_size)
        sharding = plan.batch_sharding
    stylizer = Stylizer.from_checkpoint(model_path, precision=precision,
                                        style=style,
                                        device=None if sharding else device,
                                        sharding=sharding,
                                        preserve_color=preserve_color)
    return pipeline_directory(
        stylizer.stylize_u8, files, content_dir, output_dir,
        size=size, batch_size=batch_size, num_workers=num_workers,
        skip_bad_images=skip_bad_images,
    )


def pipeline_directory(
    fwd_u8,
    files: list,
    content_dir: str,
    output_dir: str,
    *,
    size: Optional[Tuple[int, int]] = None,
    batch_size: int = 16,
    num_workers: int = 8,
    skip_bad_images: bool = False,
) -> list:
    """The bulk-job engine: decode / device run / JPEG encode as a software
    pipeline over ``files``, grouped by image shape, with short final chunks
    wrap-padded to ``batch_size`` so each shape keeps one batch size.
    ``fwd_u8`` maps a uint8 NHWC batch to a stylized uint8 batch.

    ``skip_bad_images``: log and skip an unreadable file instead of failing
    the job; the returned list keeps ``None`` at its position."""
    from PIL import Image

    os.makedirs(output_dir, exist_ok=True)

    def dec(path):
        u8 = decode_image(path)
        return resize_image(u8, size) if size is not None else u8

    # group equal shapes from the headers alone, so only one chunk of
    # decoded pixels is held at a time
    groups: Dict[Tuple[int, int], list] = {}
    if size is not None:
        groups[tuple(size)] = list(range(len(files)))
    else:
        for i, f in enumerate(files):
            try:
                with Image.open(f) as im:
                    w, h = im.size
            except Exception as e:
                if not skip_bad_images:
                    raise
                print(f"skipping unreadable {f}: {e!r}", flush=True)
                continue
            groups.setdefault((h, w), []).append(i)

    # one collision-free output path per input
    out_paths = [None] * len(files)
    used = set()
    for i, f in enumerate(files):
        rel_stem = os.path.splitext(os.path.relpath(f, content_dir))[0]
        path = os.path.join(output_dir, f"{rel_stem}_stylized.jpg")
        n = 1
        while path in used:
            path = os.path.join(output_dir, f"{rel_stem}_stylized_{n}.jpg")
            n += 1
        used.add(path)
        out_paths[i] = path

    all_chunks = [
        idxs[at:at + batch_size]
        for idxs in groups.values()
        for at in range(0, len(idxs), batch_size)
    ]

    written = [None] * len(files)
    # prep runs on ``pool`` and waits on its decodes, so they run on a pool
    # of their own: no task waits on a task of its own pool (with one
    # worker that would wait forever)
    with ThreadPoolExecutor(max_workers=num_workers) as pool, \
            ThreadPoolExecutor(max_workers=num_workers) as decode_pool:
        def try_dec(i):
            try:
                return i, dec(files[i])
            except Exception as e:
                if not skip_bad_images:
                    raise
                print(f"skipping undecodable {files[i]}: {e!r}", flush=True)
                return i, None

        def prep(chunk):
            results = list(decode_pool.map(try_dec, chunk))
            kept = [i for i, u8 in results if u8 is not None]
            if not kept:
                return kept, None
            imgs = dict(results)
            fill = kept + kept[: batch_size - len(kept)]
            while len(fill) < batch_size:
                fill = fill + kept[: batch_size - len(fill)]
            return kept, np.stack([imgs[i] for i in fill])

        def save_one(i, out):
            path = out_paths[i]
            os.makedirs(os.path.dirname(path), exist_ok=True)
            Image.fromarray(out).save(path)
            written[i] = path

        save_futures = []
        next_batch = pool.submit(prep, all_chunks[0]) if all_chunks else None
        for n, chunk in enumerate(all_chunks):
            kept, batch = next_batch.result()
            if n + 1 < len(all_chunks):
                next_batch = pool.submit(prep, all_chunks[n + 1])
            if batch is None:  # whole chunk skipped as undecodable
                continue
            outs = fwd_u8(batch)[: len(kept)]
            save_futures.extend(
                pool.submit(save_one, i, out) for i, out in zip(kept, outs)
            )
            while len(save_futures) > 2 * batch_size:
                save_futures.pop(0).result()  # bound memory, surface errors
        for f in save_futures:
            f.result()
    return written
