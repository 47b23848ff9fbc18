"""AdaIN pipeline -> ONNX (the JAX package's ``export/onnx_adain.py``).

One opset-11 graph of the whole arbitrary-style pipeline: VGG19 to relu4_1
on both inputs (``content_image``, ``style_image``; NCHW, ImageNet-
normalized), the AdaIN re-normalization of the content feature's channel
statistics to the style's, and the decoder, to ``output_image``. The style
is a runtime input: any style, no re-export. ``alpha`` is baked in, or
``"input"`` makes it a scalar graph input. ``baked_style`` freezes one
style's (mu, sigma) into the graph and drops the style input and its VGG
branch. ``preserve_color="luma"`` adds Gatys colour control in the graph.

Ops: Pad, Conv, MaxPool, Relu, Resize (nearest), ReduceMean, Sub, Mul,
Div, Sqrt, Add, all of which ``export/onnx_runtime.py`` runs. With the same
weights the graph is the JAX package's, initializer for initializer, bit
for bit; only ``producer_name`` differs.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence, Set, Union

import numpy as np

from fast_neural_style_transfer_tpu_torch.export import onnx_writer as ow
from fast_neural_style_transfer_tpu_torch.export.onnx_export import _GraphBuilder
from fast_neural_style_transfer_tpu_torch.models.adain import (
    _DECODER_CFG,
    ENCODE_TAP,
    _decoder_keys,
)
from fast_neural_style_transfer_tpu_torch.models.vgg import _CFG as VGG_CFG

CONTENT_NAME = "content_image"
STYLE_NAME = "style_image"
ALPHA_NAME = "alpha"
OUTPUT_NAME = "output_image"


def _np(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().float().numpy() if hasattr(t, "detach") else t,
                      np.float32)


class _AdaINBuilder(_GraphBuilder):
    """The stylizer graph builder plus the ops AdaIN needs."""

    def __init__(self, weights):
        super().__init__(weights)
        self._emitted: Set[str] = set()
        self._resize_consts = None

    def init_tensor(self, name: str, arr: np.ndarray) -> str:
        # both VGG branches use the same weights: emit each name once
        if name in self._emitted:
            return name
        self._emitted.add(name)
        return super().init_tensor(name, arr)

    def zero_conv(self, x: str, prefix: str, k: int = 3) -> str:
        """VGG conv: explicit constant Pad(k // 2), then a VALID Conv."""
        padded = self.fresh("zpad")
        self.nodes.append(ow.node("Pad", [x, self._pads_const(k // 2)], [padded],
                                  mode="constant"))
        out = self.fresh("conv")
        self.nodes.append(ow.node(
            "Conv", [padded, self._weight(prefix + ".weight"), self._weight(prefix + ".bias")],
            [out], strides=[1, 1], kernel_shape=[k, k]))
        return out

    def max_pool(self, x: str) -> str:
        out = self.fresh("pool")
        self.nodes.append(ow.node("MaxPool", [x], [out], kernel_shape=[2, 2], strides=[2, 2]))
        return out

    def upsample2x(self, x: str) -> str:
        """Resize nearest x2 with asymmetric coordinates and floor rounding
        (each pixel repeated)."""
        if self._resize_consts is None:
            roi = self.init_tensor("resize_roi", np.zeros((0,), np.float32))
            scales = self.init_tensor("resize_scales", np.asarray([1, 1, 2, 2], np.float32))
            self._resize_consts = (roi, scales)
        roi, scales = self._resize_consts
        out = self.fresh("up")
        self.nodes.append(ow.node("Resize", [x, roi, scales], [out], mode="nearest",
                                  coordinate_transformation_mode="asymmetric",
                                  nearest_mode="floor"))
        return out

    def scalar(self, value: float) -> str:
        return self.init_tensor(self.fresh("const"), np.asarray(value, np.float32))

    def binop(self, op: str, a: str, b: str, out: str = "") -> str:
        out = out or self.fresh(op.lower())
        self.nodes.append(ow.node(op, [a, b], [out]))
        return out

    def _mean_hw(self, x: str) -> str:
        out = self.fresh("mean")
        self.nodes.append(ow.node("ReduceMean", [x], [out], axes=[2, 3], keepdims=1))
        return out

    def _var_hw(self, x: str, mu: str) -> str:
        d = self.binop("Sub", x, mu)
        var = self.fresh("var")
        self.nodes.append(ow.node("ReduceMean", [self.binop("Mul", d, d)], [var],
                                  axes=[2, 3], keepdims=1))
        return var

    def channel_stats(self, x: str, eps: float = 1e-5):
        """(mean, sqrt(var + eps)) over H, W (``models/adain.py::channel_stats``)."""
        mu = self._mean_hw(x)
        var = self._var_hw(x, mu)
        sd = self.fresh("std")
        self.nodes.append(ow.node("Sqrt", [self.binop("Add", var, self.scalar(eps))], [sd]))
        return mu, sd

    def stats_raw(self, x: str):
        """(mean, sqrt(var)) over H, W with no epsilon, as
        ``utils/color.py::luminance_transfer`` takes them."""
        mu = self._mean_hw(x)
        var = self._var_hw(x, mu)
        sd = self.fresh("std")
        self.nodes.append(ow.node("Sqrt", [var], [sd]))
        return mu, sd

    def conv1x1_const(self, x: str, name: str, w_oihw: np.ndarray) -> str:
        """Pointwise conv with a constant weight: the RGB <-> YIQ changes of
        basis without Slice/Concat."""
        w = self.init_tensor(name, np.asarray(w_oihw, np.float32))
        out = self.fresh("mix")
        self.nodes.append(ow.node("Conv", [x, w], [out], strides=[1, 1], kernel_shape=[1, 1]))
        return out

    def channel_affine(self, name: str, vec) -> str:
        """(1, 3, 1, 1) per-channel constant (the ImageNet mean/std)."""
        return self.init_tensor(name, np.asarray(vec, np.float32).reshape(1, 3, 1, 1))

    def vgg_to_relu4_1(self, x: str) -> str:
        for name, cout in VGG_CFG:
            if not cout:
                x = self.max_pool(x)
                continue
            x = self.relu(self.zero_conv(x, f"vgg.{name}"))
            if "relu" + name[4:] == ENCODE_TAP:
                return x
        raise AssertionError(f"{ENCODE_TAP} not reached in the VGG config")


def _weights(decoder_sd: Mapping[str, Any], vgg_sd: Mapping[str, Any]) -> dict:
    """Graph weight names -> float32 OIHW arrays: ``vgg.<conv>`` up to
    relu4_1 and ``decoder.<i>`` for the decoder's i-th conv."""
    weights = {}
    for name, cout in VGG_CFG:
        if not cout:
            continue
        weights[f"vgg.{name}.weight"] = _np(vgg_sd[f"{name}.weight"])
        weights[f"vgg.{name}.bias"] = _np(vgg_sd[f"{name}.bias"])
        if "relu" + name[4:] == ENCODE_TAP:
            break
    for i, (wk, bk) in enumerate(_decoder_keys()):
        weights[f"decoder.{i}.weight"] = _np(decoder_sd[wk])
        weights[f"decoder.{i}.bias"] = _np(decoder_sd[bk])
    return weights


def _luma(g: _AdaINBuilder, h: str) -> None:
    """Gatys colour control in the graph: the stylized luminance shifted to
    the content's Y mean/std (``utils/color.py::luminance_transfer``'s
    formula) plus the content's chrominance, through YIQ, to OUTPUT_NAME."""
    from fast_neural_style_transfer_tpu_torch.utils.color import _RGB2YIQ, _YIQ2RGB
    from fast_neural_style_transfer_tpu_torch.utils.image_io import (
        IMAGENET_MEAN,
        IMAGENET_STD,
    )

    m = np.asarray(np.asarray(_RGB2YIQ, np.float32), np.float64)
    a = np.asarray(np.asarray(_YIQ2RGB, np.float32), np.float64)
    mean = g.channel_affine("imagenet.mean", IMAGENET_MEAN)
    std = g.channel_affine("imagenet.std", IMAGENET_STD)
    s01 = g.binop("Add", g.binop("Mul", h, std), mean)
    c01 = g.binop("Add", g.binop("Mul", CONTENT_NAME, std), mean)
    rgb2y = m[0:1].reshape(1, 3, 1, 1)
    y_s = g.conv1x1_const(s01, "color.rgb2y", rgb2y)
    y_c = g.conv1x1_const(c01, "color.rgb2y", rgb2y)
    mu_sy, sd_sy = g.stats_raw(y_s)
    mu_cy, sd_cy = g.stats_raw(y_c)
    y_new = g.binop(
        "Add",
        g.binop("Mul", g.binop("Div", g.binop("Sub", y_s, mu_sy),
                               g.binop("Add", sd_sy, g.scalar(1e-6))), sd_cy),
        mu_cy)
    out01 = g.binop(
        "Add",
        g.conv1x1_const(y_new, "color.y2rgb", a[:, :1].reshape(3, 1, 1, 1)),
        g.conv1x1_const(c01, "color.iq2rgb", (a[:, 1:] @ m[1:]).reshape(3, 3, 1, 1)))
    g.binop("Div", g.binop("Sub", out01, mean), std, out=OUTPUT_NAME)


def build_adain_onnx(
    decoder_sd: Mapping[str, Any],
    vgg_sd: Mapping[str, Any],
    *,
    alpha: Union[float, str] = 1.0,
    content_shape: Sequence[Union[int, str]] = (1, 3, 256, 256),
    style_shape: Sequence[Union[int, str]] = (1, 3, 256, 256),
    baked_style=None,
    preserve_color: str = "off",
    opset_version: int = 11,
) -> bytes:
    """Serialize the arbitrary-style pipeline to ONNX ModelProto bytes.

    ``decoder_sd``: ``AdaINDecoder``'s state_dict; ``vgg_sd``: VGG19's
    (``models/vgg_weights.py``). Static H and W must be multiples of 8;
    string dims are symbolic. ``baked_style``: a (mu, sigma) pair, each
    NHWC (1, 1, 1, C) (``models/adain.py::blended_style_stats``): the style
    input and its branch are dropped and ``style_shape`` is ignored.
    ``alpha``: a float baked in, or ``"input"`` for a scalar ``alpha``
    input. ``preserve_color``: "off" or "luma"."""
    shapes = [(content_shape, "content")]
    if baked_style is None:
        shapes.append((style_shape, "style"))
    for shape, what in shapes:
        for d in shape[2:]:
            if isinstance(d, int) and d % 8:
                raise ValueError(f"{what} dims {shape} must be multiples of 8")
    if preserve_color not in ("off", "luma"):
        raise ValueError(
            f"preserve_color must be 'off' or 'luma' (got {preserve_color!r}); "
            "'match' re-colors the style pixels per content and cannot be a "
            "fixed graph")

    g = _AdaINBuilder(_weights(decoder_sd, vgg_sd))
    c_feat = g.vgg_to_relu4_1(CONTENT_NAME)
    mu_c, sd_c = g.channel_stats(c_feat)
    if baked_style is not None:
        mu_arr, sd_arr = (np.transpose(_np(a), (0, 3, 1, 2)) for a in baked_style)
        mu_s = g.init_tensor("baked_style.mu", mu_arr)
        sd_s = g.init_tensor("baked_style.sigma", sd_arr)
    else:
        mu_s, sd_s = g.channel_stats(g.vgg_to_relu4_1(STYLE_NAME))
    t = g.binop("Add", g.binop("Mul", g.binop("Div", g.binop("Sub", c_feat, mu_c), sd_c),
                               sd_s), mu_s)
    if alpha == "input":
        one_minus = g.binop("Sub", g.scalar(1.0), ALPHA_NAME)
        t = g.binop("Add", g.binop("Mul", t, ALPHA_NAME),
                    g.binop("Mul", c_feat, one_minus))
    elif alpha != 1.0:
        t = g.binop("Add", g.binop("Mul", t, g.scalar(float(alpha))),
                    g.binop("Mul", c_feat, g.scalar(1.0 - float(alpha))))

    h = t
    last = len(_DECODER_CFG) - 1
    final_name = OUTPUT_NAME if preserve_color == "off" else ""
    for i, (_, up) in enumerate(_DECODER_CFG):
        if up:
            h = g.upsample2x(h)
        h = g.reflect_conv(h, f"decoder.{i}", 3, 1, out=final_name if i == last else "")
        if i != last:
            h = g.relu(h)
    if preserve_color == "luma":
        _luma(g, h)

    out_shape = list(content_shape)
    for i in (2, 3):
        if isinstance(out_shape[i], str):
            out_shape[i] = f"out_{out_shape[i]}"
    inputs = [ow.value_info(CONTENT_NAME, content_shape)]
    if baked_style is None:
        inputs.append(ow.value_info(STYLE_NAME, style_shape))
    if alpha == "input":
        inputs.append(ow.value_info(ALPHA_NAME, ()))
    graph_msg = ow.graph(g.nodes, "adain_style_transfer", inputs=inputs,
                         outputs=[ow.value_info(OUTPUT_NAME, out_shape)],
                         initializers=g.initializers)
    return ow.model(graph_msg, opset_version=opset_version)


def export_adain_onnx(decoder_sd, vgg_sd, path: str, **kw) -> str:
    """``build_adain_onnx`` written to ``path``."""
    data = build_adain_onnx(decoder_sd, vgg_sd, **kw)
    with open(path, "wb") as f:
        f.write(data)
    return path
