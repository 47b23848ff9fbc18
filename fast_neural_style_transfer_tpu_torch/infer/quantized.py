"""int8 inference for the stylizer (the JAX package's ``infer/quantized.py``).

``quantize_params`` quantizes a trained single-style state_dict once:
symmetric per-output-channel int8 conv weights (scale ``max(max |w|, 1e-12)
/ 127`` over each output channel's (C_in, kh, kw), the output channel being
axis 0 of a Conv2d's OIHW weight and axis 1 of a ConvTranspose2d's IOHW);
biases and instance-norm affines stay float32. ``apply_int8`` is the
eval-mode forward whose convolutions multiply int8 by int8 into int32, with
a symmetric per-tensor activation scale: dynamic (``max |x|`` over the whole
tensor, batch included, so an image's output depends on the images that
share its batch) or static (``calibrate``). Instance norm, the residual adds
and the statistics stay float32: every IN site runs
``ops/norm.py::instance_norm``, the hand-written IN forward kernel on a
CUDA tensor (14 launches a forward), its plain version on the CPU.

The roundings are the JAX package's: ``round(x / s)`` with a true float32
division (round half to even), clipped to [-127, 127]; the int32 product
dequantized as ``y.float() * (sx * scale) + b``. Everything between is
exact in integers, so the two packages' int8 codes agree wherever their
float inputs do.

A convolution is one integer product through ``torch._int_mm`` (cuBLASLt
on the card, exact int32 on either device; ``F.conv2d`` has no int8 path on
the card and ``F.unfold`` no int8 kernel): the int8 activation is
reflect-padded (an index gather), its k x k patches are copied from
``Tensor.unfold`` views into an (M, K) matrix, K in (kh, kw, C) order, and
multiplied by the (K, N) weight matrix. ``_int_mm`` wants M > 16 and K, N multiples of 8, so K and N
are zero-padded (conv1's K = 9*9*3 = 243 to 248, final_conv's N = 3 to 8)
and M where a tiny image leaves 16 rows or fewer: padded, never a float
fallback. The transposed convs (up1, up2) are the zero-insertion of their
int8 input and a conv with the flipped, transposed weights, exact as the
JAX package's dilated lowering is. The output (M, C_out) viewed as NHWC
and permuted to NCHW is the ``channels_last`` tensor the IN kernel takes,
with no copy.

``apply_int8_replicas`` is the forward of a batch in chunks, each on its
replica (``Stylizer(sharding=)``); ``apply_int8`` is its one-chunk case.
The chunks run in lockstep and each conv's dynamic scale is the max over
every chunk, one scalar exchange a conv, as the JAX package's one max over
the whole sharded tensor. Static scales need no exchange.

Whether int8 is faster than bf16 on the card is measured in
``chip_smoke.py``'s ``int8`` phase, not promised here.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence

import numpy as np
import torch

from fast_neural_style_transfer_tpu_torch.models.transformer import (
    NUM_RES_BLOCKS,
    layer_walk,
    require_single_style,
)
from fast_neural_style_transfer_tpu_torch.ops.conv import conv_transpose2d, reflect_conv2d
from fast_neural_style_transfer_tpu_torch.ops.cuda_pad import source_index
from fast_neural_style_transfer_tpu_torch.ops.norm import instance_norm

_EPS = 1e-12
_MIN_ROWS = 17  # torch._int_mm wants more than 16 rows

# (tree name, state_dict prefix, transposed) of every conv, in forward order
_CONVS = (
    [("conv1", "conv1.conv", False), ("conv2", "conv2.conv", False)]
    + [(f"res_blocks.{i}.{c}", f"res_blocks.{i}.{c}.conv", False)
       for i in range(NUM_RES_BLOCKS) for c in ("conv1", "conv2")]
    + [("up1", "up1.upsample_conv", True), ("up2", "up2.upsample_conv", True),
       ("final_conv", "final_conv.conv", False)]
)
_CONV_ORDER = [name for name, _, _ in _CONVS]
_NORMS = ["norm1", "norm2"] + [f"res_blocks.{i}.{n}" for i in range(NUM_RES_BLOCKS)
                               for n in ("in1", "in2")] + ["norm3", "norm4"]


def _tree(leaves: Mapping[str, Any]) -> Dict[str, Any]:
    """Nest {"res_blocks.0.conv1": leaf, "conv1": leaf, ...} as the JAX
    package's param tree: top-level names, and ``res_blocks`` a list."""
    tree: Dict[str, Any] = {"res_blocks": [{} for _ in range(NUM_RES_BLOCKS)]}
    for name, leaf in leaves.items():
        if name.startswith("res_blocks."):
            _, i, c = name.split(".")
            tree["res_blocks"][int(i)][c] = leaf
        else:
            tree[name] = leaf
    return tree


def _get(tree: Mapping[str, Any], name: str) -> Dict[str, Any]:
    if name.startswith("res_blocks."):
        _, i, c = name.split(".")
        return tree["res_blocks"][int(i)][c]
    return tree[name]


def _div127(t: torch.Tensor) -> torch.Tensor:
    """t / 127 rounded once, as on the CPU, on every device: with a Python
    number as the divisor CUDA multiplies by its float reciprocal instead,
    which is one ulp off for some t, and a scale one ulp off moves codes and
    every dequantized output of its conv."""
    return t / torch.full((), 127.0, dtype=t.dtype, device=t.device)


def _round8(n: int) -> int:
    return -(-n // 8) * 8


def _quantize_weight(w: torch.Tensor, transposed: bool) -> Dict[str, torch.Tensor]:
    """An OIHW (Conv2d) or IOHW (ConvTranspose2d) float weight -> its int8
    codes ``wq`` and per-output-channel f32 ``scale`` in that layout, and
    ``wmat``: the (N, K) int8 matrix of the equivalent direct conv (OIHW,
    flipped and transposed for ConvTranspose2d), K in (kh, kw, C_in) order,
    zero-padded to multiples of 8."""
    w = w.detach().float()
    out_axis = 1 if transposed else 0
    reduce = tuple(d for d in range(4) if d != out_axis)
    scale = _div127(torch.clamp(w.abs().amax(dim=reduce), min=_EPS))
    shape = [1, 1, 1, 1]
    shape[out_axis] = -1
    wq = torch.clamp(torch.round(w / scale.view(shape)), -127, 127).to(torch.int8)
    direct = wq.transpose(0, 1).flip(2, 3) if transposed else wq
    n, k = direct.shape[0], direct[0].numel()
    wmat = torch.zeros((_round8(n), _round8(k)), dtype=torch.int8, device=w.device)
    wmat[:n, :k] = direct.permute(0, 2, 3, 1).reshape(n, k)
    return {"wq": wq, "scale": scale, "wmat": wmat}


def quantize_params(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """Quantize a single-style stylizer state_dict's conv weights; biases and
    IN affines pass through in float32. Returns the JAX package's tree
    (``conv1: {wq, scale, b}``, ``norm1: {gamma, beta}``, ``res_blocks``: a
    list, ...), each conv also holding ``wmat`` (``_quantize_weight``), on
    the state_dict's device."""
    require_single_style(state_dict, "quantize_params")
    leaves: Dict[str, Any] = {n: {"gamma": state_dict[n + ".weight"].detach().float(),
                                  "beta": state_dict[n + ".bias"].detach().float()}
                              for n in _NORMS}
    for name, prefix, transposed in _CONVS:
        q = _quantize_weight(state_dict[prefix + ".weight"], transposed)
        q["b"] = state_dict[prefix + ".bias"].detach().float()
        leaves[name] = q
    return _tree(leaves)


def to_device(qparams: Mapping[str, Any], device) -> Dict[str, Any]:
    """The quantized tree with every tensor on ``device``."""
    def move(node):
        if isinstance(node, dict):
            return {k: move(v) for k, v in node.items()}
        if isinstance(node, list):
            return [move(v) for v in node]
        return node.to(device)
    return move(qparams)


def _quantize_act(x: torch.Tensor, static_scale=None):
    """Symmetric per-tensor int8 codes of an activation and their scale:
    dynamic (max |x| over the whole tensor) or the calibrated static one."""
    if static_scale is None:
        lo, hi = torch.aminmax(x)
        s = _div127(torch.clamp(torch.maximum(-lo, hi), min=_EPS))
    else:
        s = static_scale
    return torch.clamp(torch.round(x / s), -127, 127).to(torch.int8), s


def _reflect_pad(xq: torch.Tensor, pad: int) -> torch.Tensor:
    """NCHW int8 codes -> NHWC, reflect-padded by ``pad`` (an index gather)."""
    _, _, h, w = xq.shape
    if pad >= min(h, w):
        raise ValueError(f"reflect padding {pad} needs sides above it, got {h}x{w}")
    return (xq.permute(0, 2, 3, 1)
            .index_select(1, source_index(h, pad, device=xq.device))
            .index_select(2, source_index(w, pad, device=xq.device)))


def _zero_insert(xq: torch.Tensor) -> torch.Tensor:
    """NCHW int8 codes -> the NHWC input of ConvTranspose2d k3 s2 p1 op1 as
    a direct conv: the codes at every other position of a zero grid with one
    zero row/column before and two after."""
    n, c, h, w = xq.shape
    z = torch.zeros((n, 2 * h + 2, 2 * w + 2, c), dtype=torch.int8, device=xq.device)
    z[:, 1:2 * h:2, 1:2 * w:2, :] = xq.permute(0, 2, 3, 1)
    return z


def _patches(xp: torch.Tensor, k: int, stride: int, kp: int):
    """The (rows, kp) int8 patch matrix of a VALID k x k conv of the NHWC
    ``xp`` (K in (kh, kw, C) order, zero-padded to kp; rows = M, or 17 where
    M <= 16, the extra rows zero) and the output's (n, ho, wo). Where C is
    a multiple of 8 each tap's channels move as int64 words: the strided
    copy's cost is its per-element index arithmetic, not its bytes."""
    n, hp, wp, c = xp.shape
    ho, wo = (hp - k) // stride + 1, (wp - k) // stride + 1
    m, kk = n * ho * wo, c * k * k
    rows = max(m, _MIN_ROWS)
    a = torch.empty((rows, kp), dtype=torch.int8, device=xp.device)
    if kp > kk:
        a[:, kk:].zero_()
    if rows > m:
        a[m:].zero_()
    word = 8 if c % 8 == 0 else 1
    src, dst = (xp.view(torch.int64), a.view(torch.int64)) if word == 8 else (xp, a)
    taps = src.unfold(1, k, stride).unfold(2, k, stride)  # (n, ho, wo, c/word, kh, kw)
    dst[:m, :kk // word].view(n, ho, wo, k, k, c // word).copy_(
        taps.permute(0, 1, 2, 4, 5, 3))
    return a, (n, ho, wo)


def _dequantize(acc: torch.Tensor, out_shape, qp, sx: torch.Tensor) -> torch.Tensor:
    """int32 (rows, N) product -> float32 (n, C_out, ho, wo) channels_last:
    ``y.float() * (sx * scale) + b`` on the first M rows, C_out columns."""
    n, ho, wo = out_shape
    cout = qp["scale"].shape[0]
    y = acc[:n * ho * wo, :cout].float() * (sx * qp["scale"]) + qp["b"]
    return y.reshape(n, ho, wo, cout).permute(0, 3, 1, 2)


def _int8_conv(xp: torch.Tensor, qp: Mapping[str, torch.Tensor], sx: torch.Tensor,
               k: int, stride: int) -> torch.Tensor:
    """VALID conv of the padded int8 NHWC ``xp`` as one ``_int_mm``, then
    dequantized."""
    a, out_shape = _patches(xp, k, stride, qp["wmat"].shape[1])
    return _dequantize(torch._int_mm(a, qp["wmat"].t()), out_shape, qp, sx)


def _qreflect_conv(qp, x: torch.Tensor, *, stride: int = 1, scale=None) -> torch.Tensor:
    """Reflect-padded k x k conv of the float ``x``, quantized with
    ``scale`` (default: the conv's static ``act_scale``, else x's own
    dynamic one)."""
    xq, sx = _quantize_act(x, qp.get("act_scale") if scale is None else scale)
    k = qp["wq"].shape[-1]
    return _int8_conv(_reflect_pad(xq, k // 2), qp, sx, k, stride)


def _qconv_transpose(qp, x: torch.Tensor, *, scale=None) -> torch.Tensor:
    """ConvTranspose2d k3 s2 p1 op1 as a k3 conv of the zero-inserted codes;
    ``scale`` as for ``_qreflect_conv``."""
    xq, sx = _quantize_act(x, qp.get("act_scale") if scale is None else scale)
    return _int8_conv(_zero_insert(xq), qp, sx, 3, 1)


def _nchw(x) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).float().contiguous(memory_format=torch.channels_last)


def _shared_scales(ps, vs) -> list:
    """Every chunk's activation scale: the static scale of each replica, or
    one dynamic scale, max |x| over every chunk (computed on the first
    chunk's device, copied to the others)."""
    if ps[0].get("act_scale") is not None:
        return [p["act_scale"] for p in ps]
    dev = vs[0].device
    peaks = []
    for v in vs:
        lo, hi = torch.aminmax(v)
        peaks.append(torch.maximum(-lo, hi).to(dev))
    peak = peaks[0] if len(peaks) == 1 else torch.stack(peaks).max()
    s = _div127(torch.clamp(peak, min=_EPS))
    return [s.to(v.device) for v in vs]


def apply_int8_replicas(qtrees: Sequence[Mapping[str, Any]], xs: Sequence[torch.Tensor],
                        *, norm_method: str = "auto") -> list:
    """The int8 forward of each chunk ``xs[i]`` (NHWC network space) on its
    replica ``qtrees[i]`` (the quantized tree on that chunk's device), the
    chunks in lockstep: each conv's dynamic activation scale is shared, max
    |x| over every chunk, as the JAX package's is one max over the whole
    (sharded) batch; static scales pass through. -> the chunks' outputs."""
    if norm_method not in ("auto", "onepass"):
        raise ValueError(f"unknown norm_method {norm_method!r}")
    onepass = norm_method == "onepass"

    def conv(name, vs, stride):
        ps = [_get(t, name) for t in qtrees]
        return [_qreflect_conv(p, v, stride=stride, scale=s)
                for p, v, s in zip(ps, vs, _shared_scales(ps, vs))]

    def up(name, vs):
        ps = [_get(t, name) for t in qtrees]
        return [_qconv_transpose(p, v, scale=s) for p, v, s in zip(ps, vs, _shared_scales(ps, vs))]

    def inorm(name, vs, relu):
        ps = [_get(t, name) for t in qtrees]
        return [instance_norm(v, p["gamma"], p["beta"], relu=relu, onepass=onepass)
                for v, p in zip(vs, ps)]

    out = layer_walk([_nchw(x) for x in xs], conv=conv, up=up, inorm=inorm,
                     add=lambda a, b: [x + y for x, y in zip(a, b)])
    return [o.permute(0, 2, 3, 1).to(x.dtype) for o, x in zip(out, xs)]


def apply_int8(qparams: Mapping[str, Any], x: torch.Tensor, *,
               norm_method: str = "auto") -> torch.Tensor:
    """Eval-mode int8 forward, NHWC network space in and out (x's dtype),
    on the device of ``qparams`` and x: ``apply_int8_replicas`` of one
    chunk. ``norm_method``: "auto" (stable IN statistics) or "onepass"."""
    return apply_int8_replicas([qparams], [x], norm_method=norm_method)[0]


@torch.inference_mode()
def calibrate(qparams: Mapping[str, Any], state_dict: Mapping[str, torch.Tensor],
              sample, margin: float = 1.05) -> Dict[str, Any]:
    """A copy of the quantized tree with static activation scales: the
    float forward of ``state_dict`` on ``sample`` (a representative NHWC
    network-space batch) records each conv input's max |x|, and that conv
    gets ``act_scale = max(max |x|, 1e-12) * margin / 127`` (float32). Runs
    on the device of ``qparams``, through the same ``layer_walk`` as
    ``apply_int8``, so a static ``act_scale`` cannot attach to the wrong
    conv."""
    dev = qparams["conv1"]["wq"].device
    sd = {k: v.detach().float().to(dev) for k, v in state_dict.items()}
    maxes: Dict[str, float] = {}

    def record(name, v):
        maxes[name] = float(v.abs().max())
        return v

    def conv(name, v, stride):
        return reflect_conv2d(record(name, v), sd[name + ".conv.weight"],
                              sd[name + ".conv.bias"], stride=stride)

    def up(name, v):
        return conv_transpose2d(record(name, v), sd[name + ".upsample_conv.weight"],
                                sd[name + ".upsample_conv.bias"], stride=2, padding=1,
                                output_padding=1)

    x = torch.as_tensor(np.asarray(sample, np.float32) if not torch.is_tensor(sample)
                        else sample).to(dev)
    layer_walk(_nchw(x), conv=conv, up=up,
               inorm=lambda name, v, relu: instance_norm(v, sd[name + ".weight"],
                                                         sd[name + ".bias"], relu=relu))
    out = {n: dict(v) for n, v in qparams.items() if n != "res_blocks"}
    out["res_blocks"] = [{c: dict(p) for c, p in rb.items()} for rb in qparams["res_blocks"]]
    for name in _CONV_ORDER:
        _get(out, name)["act_scale"] = torch.tensor(
            max(maxes[name], _EPS) * margin / 127.0, dtype=torch.float32, device=dev)
    return out
