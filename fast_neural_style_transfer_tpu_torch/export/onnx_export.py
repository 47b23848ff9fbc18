"""Stylizer -> ONNX export (the JAX package's ``export/onnx_export.py``).

The reference exports ``torch.onnx.export(opset 11, input_names=
['input_image'], output_names=['output_image'], static 1x3x256x256)``.
This builds the same interface graph from the port's state_dict through
the hand-rolled protobuf writer (``export/onnx_writer.py``): no ``onnx``
package and no tracing. With the same weights the graph is the JAX
package's node for node, initializer for initializer, bit for bit; only
``producer_name`` differs. NCHW (ONNX's convention), eval-mode semantics
(no dropout).

Ops (all opset-11 standard): Pad(reflect), Conv, InstanceNormalization,
Relu, Add, ConvTranspose.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Union

import numpy as np

from fast_neural_style_transfer_tpu_torch.export import onnx_writer as ow
from fast_neural_style_transfer_tpu_torch.export.torch_convert import to_torch_state_dict
from fast_neural_style_transfer_tpu_torch.models.transformer import layer_walk

INPUT_NAME = "input_image"
OUTPUT_NAME = "output_image"


class _GraphBuilder:
    """Nodes and initializers of one graph, with fresh value names."""

    def __init__(self, weights: Mapping[str, np.ndarray]):
        self.weights = weights
        self.nodes: List[bytes] = []
        self.initializers: List[bytes] = []
        self._n = 0
        self._pad_cache: Dict[int, str] = {}

    def fresh(self, hint: str) -> str:
        self._n += 1
        return f"{hint}_{self._n}"

    def init_tensor(self, name: str, arr: np.ndarray) -> str:
        self.initializers.append(ow.tensor(name, arr))
        return name

    def _weight(self, key: str) -> str:
        return self.init_tensor(key, self.weights[key])

    def _pads_const(self, p: int) -> str:
        if p not in self._pad_cache:
            self._pad_cache[p] = self.init_tensor(
                f"pads_{p}", np.asarray([0, 0, p, p, 0, 0, p, p], np.int64))
        return self._pad_cache[p]

    def reflect_conv(self, x: str, prefix: str, k: int, stride: int,
                     out: str = "") -> str:
        padded = self.fresh("pad")
        self.nodes.append(
            ow.node("Pad", [x, self._pads_const(k // 2)], [padded], mode="reflect"))
        out = out or self.fresh("conv")
        self.nodes.append(ow.node(
            "Conv",
            [padded, self._weight(prefix + ".weight"), self._weight(prefix + ".bias")],
            [out], strides=[stride, stride], kernel_shape=[k, k]))
        return out

    def conv_transpose(self, x: str, prefix: str, k: int) -> str:
        out = self.fresh("convt")
        self.nodes.append(ow.node(
            "ConvTranspose",
            [x, self._weight(prefix + ".weight"), self._weight(prefix + ".bias")],
            [out], strides=[2, 2], pads=[k // 2] * 4, output_padding=[1, 1],
            kernel_shape=[k, k]))
        return out

    def inorm(self, x: str, prefix: str) -> str:
        out = self.fresh("inorm")
        self.nodes.append(ow.node(
            "InstanceNormalization",
            [x, self._weight(prefix + ".weight"), self._weight(prefix + ".bias")],
            [out], epsilon=1e-5))
        return out

    def relu(self, x: str) -> str:
        out = self.fresh("relu")
        self.nodes.append(ow.node("Relu", [x], [out]))
        return out

    def add(self, a: str, b: str, out_name: str = "") -> str:
        out = out_name or self.fresh("add")
        self.nodes.append(ow.node("Add", [a, b], [out]))
        return out


def build_onnx_model(
    state_dict,
    *,
    input_shape: Sequence[Union[int, str]] = (1, 3, 256, 256),
    opset_version: int = 11,
) -> bytes:
    """Serialize a single-style stylizer (a ``TransformerNet`` or its
    state_dict) to ONNX ModelProto bytes. A multi-style (S, C) bank is
    refused: ``bake_style`` it first.

    ``input_shape`` entries may be strings (dim_param) for dynamic axes;
    the default is the reference's static export."""
    g = _GraphBuilder(to_torch_state_dict(state_dict))

    def conv(name, h, stride):
        prefix = name + ".conv"
        k = g.weights[prefix + ".weight"].shape[-1]
        return g.reflect_conv(h, prefix, k, stride,
                              out=OUTPUT_NAME if name == "final_conv" else "")

    def up(name, h):
        prefix = name + ".upsample_conv"
        return g.conv_transpose(h, prefix, g.weights[prefix + ".weight"].shape[-1])

    def inorm(name, h, relu):
        h = g.inorm(h, name)
        return g.relu(h) if relu else h

    layer_walk(INPUT_NAME, conv=conv, up=up, inorm=inorm, add=g.add)

    # The output's H and W equal the input's only for multiples of 4 (each
    # stride-2 encoder conv ceils, the decoder doubles twice): symbolic dims
    # get distinct out_* dim_params, static ones are rounded up.
    out_shape = list(input_shape)
    for i in (2, 3):
        if isinstance(out_shape[i], str):
            out_shape[i] = f"out_{out_shape[i]}"
        else:
            out_shape[i] = -(-out_shape[i] // 4) * 4
    graph_msg = ow.graph(
        g.nodes, "style_transfer_net",
        inputs=[ow.value_info(INPUT_NAME, input_shape)],
        outputs=[ow.value_info(OUTPUT_NAME, out_shape)],
        initializers=g.initializers)
    return ow.model(graph_msg, opset_version=opset_version)


def export_onnx(state_dict, path: str, **kw) -> str:
    """``build_onnx_model`` written to ``path``."""
    data = build_onnx_model(state_dict, **kw)
    with open(path, "wb") as f:
        f.write(data)
    return path
