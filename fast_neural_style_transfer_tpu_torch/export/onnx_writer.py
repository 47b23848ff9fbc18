"""Minimal ONNX protobuf writer — no ``onnx`` package required.

Hand-rolled protobuf wire-format encoding of the ONNX ``ModelProto`` subset
the stylizer graph needs (field numbers from the public onnx.proto schema,
which is stable across IR versions). Wire format recap:

    tag = (field_number << 3) | wire_type
    wire type 0 = varint, 2 = length-delimited, 5 = 32-bit (float)

Every message is built as bytes; repeated messages are repeated tagged
fields; packed repeated int64 (dims, ints) are a single length-delimited
blob of varints.
"""

from __future__ import annotations

import struct
from typing import Sequence, Union

import numpy as np

# ONNX TensorProto.DataType
FLOAT = 1
INT64 = 7

# AttributeProto.AttributeType
ATTR_FLOAT = 1
ATTR_INT = 2
ATTR_STRING = 3
ATTR_INTS = 7


def _varint(n: int) -> bytes:
    if n < 0:
        n += 1 << 64  # two's-complement, 10-byte varint
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _ld(field: int, payload: bytes) -> bytes:
    """length-delimited field"""
    return _tag(field, 2) + _varint(len(payload)) + payload


def _vint(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(value)


def _f32(field: int, value: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", value)


def _string(field: int, s: Union[str, bytes]) -> bytes:
    return _ld(field, s.encode() if isinstance(s, str) else s)


def _packed_varints(field: int, values: Sequence[int]) -> bytes:
    return _ld(field, b"".join(_varint(v) for v in values))


# -- message builders --------------------------------------------------------


def tensor(name: str, array: np.ndarray) -> bytes:
    """TensorProto: dims(1, packed) data_type(2) name(8) raw_data(9)."""
    array = np.ascontiguousarray(array)
    if array.dtype == np.float32:
        dtype = FLOAT
    elif array.dtype == np.int64:
        dtype = INT64
    else:
        raise ValueError(f"unsupported ONNX tensor dtype {array.dtype}")
    msg = b""
    if array.ndim:
        msg += _packed_varints(1, array.shape)
    msg += _vint(2, dtype)
    msg += _string(8, name)
    msg += _ld(9, array.tobytes())
    return msg


def _attr(name: str, *, i=None, f=None, s=None, ints=None) -> bytes:
    """AttributeProto: name(1) f(2) i(3) s(4) ints(8) type(20)."""
    msg = _string(1, name)
    if f is not None:
        msg += _f32(2, f) + _vint(20, ATTR_FLOAT)
    elif i is not None:
        msg += _vint(3, i) + _vint(20, ATTR_INT)
    elif s is not None:
        msg += _string(4, s) + _vint(20, ATTR_STRING)
    elif ints is not None:
        msg += b"".join(_vint(8, v) for v in ints) + _vint(20, ATTR_INTS)
    else:
        raise ValueError("empty attribute")
    return msg


def node(
    op_type: str,
    inputs: Sequence[str],
    outputs: Sequence[str],
    name: str = "",
    **attrs,
) -> bytes:
    """NodeProto: input(1) output(2) name(3) op_type(4) attribute(5).

    Attribute values: int -> INT, float -> FLOAT, str -> STRING,
    list/tuple of int -> INTS.
    """
    msg = b"".join(_string(1, i) for i in inputs)
    msg += b"".join(_string(2, o) for o in outputs)
    if name:
        msg += _string(3, name)
    msg += _string(4, op_type)
    for k, v in attrs.items():
        if isinstance(v, bool):
            raise ValueError("bool attrs not supported")
        if isinstance(v, int):
            msg += _ld(5, _attr(k, i=v))
        elif isinstance(v, float):
            msg += _ld(5, _attr(k, f=v))
        elif isinstance(v, str):
            msg += _ld(5, _attr(k, s=v))
        elif isinstance(v, (list, tuple)):
            msg += _ld(5, _attr(k, ints=list(v)))
        else:
            raise ValueError(f"unsupported attr type for {k}: {type(v)}")
    return msg


def value_info(name: str, dims: Sequence[Union[int, str]], elem_type: int = FLOAT) -> bytes:
    """ValueInfoProto: name(1) type(2); dims may be ints or dim_param strings."""
    shape_msg = b""
    for d in dims:
        if isinstance(d, str):
            dim = _string(2, d)  # dim_param
        else:
            dim = _vint(1, d)  # dim_value
        shape_msg += _ld(1, dim)
    tensor_type = _vint(1, elem_type) + _ld(2, shape_msg)
    type_proto = _ld(1, tensor_type)
    return _string(1, name) + _ld(2, type_proto)


def graph(
    nodes: Sequence[bytes],
    name: str,
    inputs: Sequence[bytes],
    outputs: Sequence[bytes],
    initializers: Sequence[bytes],
) -> bytes:
    """GraphProto: node(1) name(2) initializer(5) input(11) output(12)."""
    msg = b"".join(_ld(1, n) for n in nodes)
    msg += _string(2, name)
    msg += b"".join(_ld(5, t) for t in initializers)
    msg += b"".join(_ld(11, vi) for vi in inputs)
    msg += b"".join(_ld(12, vi) for vi in outputs)
    return msg


def model(
    graph_msg: bytes,
    *,
    opset_version: int = 11,
    ir_version: int = 6,
    producer: str = "fast_neural_style_transfer_tpu_torch",
) -> bytes:
    """ModelProto: ir_version(1) producer_name(2) graph(7) opset_import(8)."""
    opset = _vint(2, opset_version)  # OperatorSetIdProto: domain(1) empty, version(2)
    return (
        _vint(1, ir_version)
        + _string(2, producer)
        + _ld(7, graph_msg)
        + _ld(8, opset)
    )
