"""A minimal ONNX runtime for the exported graphs (the JAX package's
``export/onnx_runtime.py``), on torch tensors on an explicit device.

Neither ``onnx`` nor ``onnxruntime`` is a dependency, so this module holds
(a) a wire-format parser for the ModelProto subset the exporters write (and
protoc's packed encodings of it), and (b) an executor for the ops those
graphs use: Pad (reflect, constant), Conv, ConvTranspose,
InstanceNormalization, Relu, Add, Sub, Mul, Div, Sqrt, ReduceMean, MaxPool
and Resize (nearest). It is also the round-trip check of the writer.

Tensors inside the graph are NCHW, as ONNX has them, kept in
``torch.channels_last`` memory format (physically NHWC) through Pad, Conv,
ConvTranspose and Add, so that each InstanceNormalization node reaches
``ops/norm.py::instance_norm`` with no copy: on a CUDA tensor that launches
the hand-written IN forward kernel (``relu=False``: Relu is a node of its
own), on a CPU tensor its plain version. Semantics-bearing attributes the
executor does not implement raise instead of running wrong.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from fast_neural_style_transfer_tpu_torch.core.shapes import resolve_device
from fast_neural_style_transfer_tpu_torch.ops.conv import max_pool2d
from fast_neural_style_transfer_tpu_torch.ops.norm import instance_norm

# -- wire-format reader ------------------------------------------------------


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    n = 0
    shift = 0
    while True:
        b = buf[i]
        n |= (b & 0x7F) << shift
        shift += 7
        i += 1
        if not b & 0x80:
            return n, i


def _fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a protobuf message."""
    i = 0
    while i < len(buf):
        tag, i = _read_varint(buf, i)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            v, i = _read_varint(buf, i)
        elif wire == 2:
            ln, i = _read_varint(buf, i)
            v = buf[i : i + ln]
            i += ln
        elif wire == 5:
            v = struct.unpack("<f", buf[i : i + 4])[0]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, v


def _packed(v: bytes) -> List[int]:
    out, j = [], 0
    while j < len(v):
        d, j = _read_varint(v, j)
        out.append(d)
    return out


def _parse_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    dims: List[int] = []
    dtype = None
    name = ""
    raw = b""
    for field, wire, v in _fields(buf):
        if field == 1:
            dims.extend(_packed(v) if wire == 2 else [v])
        elif field == 2:
            dtype = v
        elif field == 8:
            name = v.decode()
        elif field == 9:
            raw = v
    np_dtype = {1: np.float32, 7: np.int64}[dtype]
    return name, np.frombuffer(raw, np_dtype).reshape(dims)


def _parse_attr(buf: bytes) -> Tuple[str, Any]:
    name = ""
    value: Any = None
    ints: List[int] = []
    for field, wire, v in _fields(buf):
        if field == 1:
            name = v.decode()
        elif field in (2, 3):  # float, int
            value = v
        elif field == 4:
            value = v.decode()  # string
        elif field == 8:
            # repeated int64: protoc and onnx pack these (one blob of
            # varints), the writer here does not; accept both
            ints.extend(_packed(v) if wire == 2 else [v])
    return name, (ints if ints else value)


def _parse_node(buf: bytes) -> Dict[str, Any]:
    n: Dict[str, Any] = {"inputs": [], "outputs": [], "op": "", "attrs": {}}
    for field, wire, v in _fields(buf):
        if field == 1:
            n["inputs"].append(v.decode())
        elif field == 2:
            n["outputs"].append(v.decode())
        elif field == 4:
            n["op"] = v.decode()
        elif field == 5:
            k, val = _parse_attr(v)
            n["attrs"][k] = val
    return n


def parse_model(data: bytes) -> Dict[str, Any]:
    """ModelProto bytes -> {nodes, initializers, inputs, outputs, opset}."""
    graph_buf = None
    opset = None
    for field, wire, v in _fields(data):
        if field == 7:
            graph_buf = v
        elif field == 8:
            for f2, _, v2 in _fields(v):
                if f2 == 2:
                    opset = v2
    if graph_buf is None:
        raise ValueError("no graph in ONNX model")
    nodes, inits, g_in, g_out = [], {}, [], []
    for field, wire, v in _fields(graph_buf):
        if field == 1:
            nodes.append(_parse_node(v))
        elif field == 5:
            name, arr = _parse_tensor(v)
            inits[name] = arr
        elif field in (11, 12):
            for f2, _, v2 in _fields(v):
                if f2 == 1:
                    (g_in if field == 11 else g_out).append(v2.decode())
    return {"nodes": nodes, "initializers": inits, "inputs": g_in,
            "outputs": g_out, "opset": opset}


# -- executor ----------------------------------------------------------------


def _cl(x: torch.Tensor) -> torch.Tensor:
    """A 4-D activation in channels_last (no copy where it already is)."""
    return x.contiguous(memory_format=torch.channels_last) if x.dim() == 4 else x


def _string(v) -> str:
    return v.decode() if isinstance(v, bytes) else v


def _pad(x: torch.Tensor, pads: np.ndarray, mode: str) -> torch.Tensor:
    rank = x.dim()
    pairs = [(int(pads[d]), int(pads[d + rank])) for d in range(rank)]
    if mode not in ("constant", "reflect"):
        raise NotImplementedError(f"ONNX Pad mode {mode!r} not supported")
    if mode == "reflect":
        if any(pairs[d] != (0, 0) for d in range(rank - 2)):
            raise NotImplementedError("reflect Pad of other than the last two dims")
        pairs = pairs[-2:]
    flat = [p for pair in reversed(pairs) for p in pair]  # F.pad: last dim first
    return _cl(F.pad(x, flat, mode=mode))


def _conv(x, w, b, attrs) -> torch.Tensor:
    strides = attrs.get("strides", [1, 1])
    if any(attrs.get("pads", [])):
        raise NotImplementedError(
            "ONNX Conv pads attribute not supported (this runner expects "
            "explicit Pad nodes, as the exporters emit)")
    if any(d != 1 for d in attrs.get("dilations", [1, 1])):
        raise NotImplementedError("ONNX Conv dilations not supported")
    if attrs.get("group", 1) != 1:
        raise NotImplementedError("ONNX Conv group != 1 not supported")
    if len(set(strides)) > 1:
        raise NotImplementedError(f"anisotropic Conv strides {strides}")
    return F.conv2d(x, w, b, stride=strides[0])


def _conv_transpose(x, w, b, attrs) -> torch.Tensor:
    strides = attrs.get("strides", [1, 1])
    pads = attrs.get("pads", [0, 0, 0, 0])
    op_pads = attrs.get("output_padding", [0, 0])
    if attrs.get("group", 1) != 1:
        raise NotImplementedError("ConvTranspose group != 1 not supported")
    if len(set(pads)) > 1 or len(set(strides)) > 1 or len(set(op_pads)) > 1:
        raise NotImplementedError(
            f"asymmetric ConvTranspose pads/strides/output_padding not "
            f"supported: pads={pads} strides={strides} output_padding={op_pads}")
    return F.conv_transpose2d(x, w, b, stride=strides[0], padding=pads[0],
                              output_padding=op_pads[0])


def _max_pool(x, attrs) -> torch.Tensor:
    ks = attrs.get("kernel_shape", [2, 2])
    strides = attrs.get("strides", ks)
    if any(attrs.get("pads", [])):
        raise NotImplementedError("ONNX MaxPool pads not supported")
    if list(ks) != [2, 2] or list(strides) != [2, 2]:
        raise NotImplementedError(f"only 2x2/2 MaxPool supported, got {ks}/{strides}")
    return _cl(max_pool2d(x))


def _resize(x, s: np.ndarray, attrs) -> torch.Tensor:
    mode = _string(attrs.get("mode", "nearest"))
    ctm = _string(attrs.get("coordinate_transformation_mode", "half_pixel"))
    nm = _string(attrs.get("nearest_mode", "round_prefer_floor"))
    if (mode, ctm, nm) != ("nearest", "asymmetric", "floor"):
        raise NotImplementedError(
            f"only nearest/asymmetric/floor Resize supported, got {(mode, ctm, nm)}")
    if s.shape != (4,) or s[0] != 1 or s[1] != 1 or s[2] != int(s[2]) \
            or s[3] != int(s[3]):
        raise NotImplementedError(f"only integer NCHW spatial Resize scales supported: {s}")
    # nearest + asymmetric + floor at an integer scale repeats each pixel
    out = x.repeat_interleave(int(s[2]), dim=2).repeat_interleave(int(s[3]), dim=3)
    return _cl(out)


def _run_node(op: str, ins: List[str], env: Mapping[str, torch.Tensor],
              consts: Mapping[str, np.ndarray], attrs: Mapping[str, Any]) -> torch.Tensor:
    """One node. Pad's pads and Resize's scales are read from the graph's
    initializers on the host (``consts``), never from the device."""
    x = [env[i] for i in ins]
    if op == "Pad":
        return _pad(x[0], consts[ins[1]], _string(attrs.get("mode", "constant")))
    if op == "Conv":
        return _cl(_conv(x[0], x[1], x[2] if len(x) > 2 else None, attrs))
    if op == "ConvTranspose":
        return _cl(_conv_transpose(x[0], x[1], x[2] if len(x) > 2 else None, attrs))
    if op == "InstanceNormalization":
        return instance_norm(_cl(x[0]), x[1], x[2], eps=attrs.get("epsilon", 1e-5))
    if op == "Relu":
        return torch.relu(x[0])
    if op in ("Add", "Sub", "Mul", "Div"):
        fn = {"Add": torch.add, "Sub": torch.sub, "Mul": torch.mul, "Div": torch.div}[op]
        return fn(x[0], x[1])
    if op == "Sqrt":
        return torch.sqrt(x[0])
    if op == "ReduceMean":
        axes = list(attrs.get("axes", [])) or list(range(x[0].dim()))
        return x[0].mean(dim=axes, keepdim=bool(attrs.get("keepdims", 1)))
    if op == "MaxPool":
        return _max_pool(x[0], attrs)
    if op == "Resize":
        return _resize(x[0], consts[ins[2]], attrs)
    raise NotImplementedError(f"ONNX op {op} not supported by this runner")


@torch.inference_mode()
def run_model(
    data: bytes,
    feeds: Mapping[str, Union[np.ndarray, torch.Tensor, float]],
    *,
    device: Optional[Union[str, torch.device]] = None,
) -> List[torch.Tensor]:
    """Execute an ONNX graph on ``device`` (None: the card; "cpu" on
    request). ``feeds``: the graph inputs by name, NCHW float32 arrays or
    tensors (a scalar for an ``alpha`` input). Returns the graph outputs as
    float32 tensors on ``device``, NCHW."""
    dev = resolve_device(device)
    m = parse_model(data)
    env: Dict[str, torch.Tensor] = {
        k: torch.from_numpy(np.array(v)).to(dev) for k, v in m["initializers"].items()}
    for k, v in feeds.items():
        t = v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v, np.float32))
        env[k] = _cl(t.to(dev, torch.float32))
    for n in m["nodes"]:
        env[n["outputs"][0]] = _run_node(n["op"], n["inputs"], env,
                                         m["initializers"], n["attrs"])
    return [env[o] for o in m["outputs"]]


def onnx_stylize(model_path: str, image_path: str, output_path: str, *,
                 device: Optional[Union[str, torch.device]] = None) -> str:
    """File-level ONNX inference: the image at 256x256, ImageNet-normalized,
    as a batched NCHW input; the output saved as an image."""
    from fast_neural_style_transfer_tpu_torch.utils.image_io import load_image, save_image

    with open(model_path, "rb") as f:
        data = f.read()
    x = load_image(image_path, (256, 256))  # NHWC normalized
    (out,) = run_model(data, {"input_image": np.transpose(x, (0, 3, 1, 2))},
                       device=device)
    save_image(out.permute(0, 2, 3, 1).cpu().numpy(), output_path)
    return output_path
