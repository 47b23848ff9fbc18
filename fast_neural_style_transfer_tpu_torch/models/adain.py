"""AdaIN arbitrary-style transfer (Huang & Belongie 2017, arXiv:1703.06868),
the JAX package's ``models/adain.py``.

One trained decoder stylizes with any style image: encode content and
style through the frozen VGG19 to relu4_1, re-normalize the content
feature's per-channel statistics to the style feature's (adaptive instance
norm), decode back to pixels. ``alpha`` blends the AdaIN target with the
content feature.

``adain(c, s) = sigma_s * (c - mu_c) / sigma_c + mu_s`` is instance norm
with a per-sample affine, gamma = sigma_s and beta = mu_s: on a CUDA tensor
it runs the IN forward kernel (``ops/norm.py::instance_norm``) with an
(N, C) affine, or a (C,) one for one style row (a cached or blended style);
on the CPU the JAX package's formula. The masked path (``feature_masks``,
per-pixel weights) is not an instance norm and stays plain torch, as it is
plain jnp there.

``AdaINDecoder`` mirrors VGG19 down from relu4_1 with reflect-padded 3x3
convs, ReLU after all but the last, and nearest x2 upsampling. It is an
``nn.Sequential`` of the public AdaIN decoder's layout (ReflectionPad2d,
Conv2d, ReLU, Upsample), so its state_dict keys (``1.weight``, ``5.weight``,
...) are those of the public pretrained decoders. Its forward is NHWC in and
out, like the JAX package's ``AdaINDecoder.apply``. ``load_decoder`` reads
that layout, the JAX package's ``.npz`` and the port's checkpoints.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from fast_neural_style_transfer_tpu_torch.core.dtypes import Precision
from fast_neural_style_transfer_tpu_torch.ops.conv import reflect_conv2d
from fast_neural_style_transfer_tpu_torch.ops.norm import instance_norm

ENCODE_TAP = "relu4_1"
STYLE_TAPS: Tuple[str, ...] = ("relu1_1", "relu2_1", "relu3_1", "relu4_1")

# Decoder program: mirror of VGG19 conv1_1..relu4_1. Entries are
# (out_channels, upsample_before). All 3x3 reflect convs + ReLU except the
# final 64->3, which is linear (pixels come back in network space).
_DECODER_CFG: Tuple[Tuple[int, bool], ...] = (
    (256, False),          # 512 -> 256
    (256, True), (256, False), (256, False), (128, False),  # x2 up, 256 stage
    (128, True), (64, False),                               # x2 up, 128 stage
    (64, True), (3, False),                                 # x2 up, to RGB
)

StateDict = Dict[str, torch.Tensor]


def resolve_style_weights(styles, style_weights):
    """(styles list, validated convex weights) from the one-image-or-list
    ``style`` argument; equal weights when none are given."""
    styles = list(styles) if isinstance(styles, (list, tuple)) else [styles]
    if style_weights is None:
        return styles, [1.0 / len(styles)] * len(styles)
    weights = [float(w) for w in style_weights]
    if len(weights) != len(styles):
        raise ValueError(f"{len(weights)} style_weights for {len(styles)} style images")
    if any(w < 0 for w in weights) or abs(sum(weights) - 1.0) > 1e-3:
        raise ValueError(
            f"style interpolation weights must be convex (>= 0, sum to "
            f"1); got {weights} with sum {sum(weights):.4f}")
    return styles, weights


def channel_stats(x: torch.Tensor, eps: float = 1e-5):
    """Per-(batch, channel) mean and std over H, W of an NHWC tensor: f32,
    biased variance (instance norm's statistics), each (B, 1, 1, C)."""
    xf = x.float()
    mean = xf.mean(dim=(1, 2), keepdim=True)
    var = (xf - mean).square().mean(dim=(1, 2), keepdim=True)
    return mean, torch.sqrt(var + eps)


def adain_with_stats(content_feat: torch.Tensor, mu_s: torch.Tensor,
                     sigma_s: torch.Tensor) -> torch.Tensor:
    """``sigma_s * (c - mu_c) / sigma_c + mu_s`` for NHWC ``content_feat``
    and style moments (B or 1, 1, 1, C) f32; output in c's dtype.

    On a CUDA tensor: the IN forward kernel with gamma = sigma_s and beta =
    mu_s, an (N, C) affine, or (C,) for one row. On the CPU: the JAX
    package's formula."""
    c = content_feat.shape[-1]
    if content_feat.device.type == "cuda":
        x = content_feat.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        gamma, beta = sigma_s.reshape(-1, c), mu_s.reshape(-1, c)
        if gamma.shape[0] == 1:
            gamma, beta = gamma[0], beta[0]
        return instance_norm(x, gamma, beta).permute(0, 2, 3, 1)
    mu_c, sigma_c = channel_stats(content_feat)
    out = sigma_s * (content_feat.float() - mu_c) / sigma_c + mu_s
    return out.to(content_feat.dtype)


def adain(content_feat: torch.Tensor, style_feat: torch.Tensor) -> torch.Tensor:
    """Adaptive instance norm (paper eq. 8): re-normalize the content
    feature's channel statistics to the style feature's; NHWC, the style
    batch 1 or the content's."""
    mu_s, sigma_s = channel_stats(style_feat)
    return adain_with_stats(content_feat, mu_s, sigma_s)


def blended_style_stats(vgg: nn.Module, style, style_weights=None, *,
                        precision: Precision = Precision.f32()):
    """The interpolation-folded style moments: one (mu, sigma) pair with
    ``sigma * c_norm + mu`` equal to the convex combination of the
    per-style AdaIN targets (sum_s w_s (sigma_s c_norm + mu_s)). Serving
    caches this pair instead of re-encoding styles per content batch."""
    styles, weights = resolve_style_weights(style, style_weights)
    mu_s = sigma_s = 0.0
    for s_img, w in zip(styles, weights):
        (s_feat,) = vgg(s_img, (ENCODE_TAP,), precision=precision)
        mu, sigma = channel_stats(s_feat)
        mu_s = mu_s + w * mu
        sigma_s = sigma_s + w * sigma
    return mu_s, sigma_s


class AdaINDecoder(nn.Sequential):
    """relu4_1 feature map (B, H/8, W/8, 512) -> network-space image
    (B, H, W, 3), NHWC both ways. Parameters stay float32; convs cast them
    to the compute dtype. Init is PyTorch's default (the JAX package's
    ``_init_conv``)."""

    def __init__(self):
        layers = []
        cin = 512
        last = len(_DECODER_CFG) - 1
        for i, (cout, up) in enumerate(_DECODER_CFG):
            if up:
                layers.append(nn.Upsample(scale_factor=2, mode="nearest"))
            layers.append(nn.ReflectionPad2d(1))
            layers.append(nn.Conv2d(cin, cout, 3))
            if i != last:
                layers.append(nn.ReLU())
            cin = cout
        super().__init__(*layers)

    def convs(self) -> list:
        return [m for m in self if isinstance(m, nn.Conv2d)]

    def forward(self, feat: torch.Tensor,
                precision: Precision = Precision.f32()) -> torch.Tensor:
        x = feat.permute(0, 3, 1, 2).to(precision.compute_dtype)
        x = x.contiguous(memory_format=torch.channels_last)
        # each conv's ReLU, and the nearest x2 upsample after it, are read
        # through by the next conv's reflect pad (one pass on the card)
        for i, ((_, up), conv) in enumerate(zip(_DECODER_CFG, self.convs())):
            x = reflect_conv2d(x, conv.weight, conv.bias, relu=i > 0,
                               upsample=2 if up else 1)
        return x.permute(0, 2, 3, 1)


def feature_masks(style_masks, hw: Tuple[int, int], num_styles: int) -> torch.Tensor:
    """Validate and downsample (S, H, W) per-pixel style masks to the
    relu4_1 grid: average-pooled 8x down, normalized to sum to 1 per
    feature pixel; pixels where every mask is ~0 take a uniform blend.
    Returns (S, H/8, W/8) f32."""
    m = torch.as_tensor(np.asarray(style_masks, np.float32))
    if m.dim() != 3 or m.shape[0] != num_styles:
        raise ValueError(f"style_masks must be (S={num_styles}, H, W); got "
                         f"{tuple(m.shape)}")
    if tuple(m.shape[1:]) != tuple(hw):
        raise ValueError(f"style_masks spatial shape {tuple(m.shape[1:])} must "
                         f"equal the content's {tuple(hw)}")
    s, h, w = m.shape
    mf = m.reshape(s, h // 8, 8, w // 8, 8).mean(dim=(2, 4))
    total = mf.sum(dim=0, keepdim=True)
    uniform = torch.full_like(mf, 1.0 / s)
    return torch.where(total > 1e-6, mf / torch.clamp(total, min=1e-6), uniform)


def stylize_arbitrary(
    decoder: AdaINDecoder,
    vgg: nn.Module,
    content: torch.Tensor,
    style,
    *,
    alpha: float = 1.0,
    style_weights=None,
    style_masks=None,
    precision: Precision = Precision.f32(),
) -> torch.Tensor:
    """One arbitrary-style forward: encode both, AdaIN, blend, decode.

    ``content``: network-space NHWC on the modules' device, H and W
    multiples of 8. ``style``: one NHWC style image or a list, which
    interpolates the styles' AdaIN targets with convex ``style_weights``
    (default equal). ``style_masks``: (S, H, W) per-pixel style weights
    (paper §7.3), exclusive with ``style_weights``. ``alpha`` in [0, 1]: 1
    is full stylization, 0 reconstructs the content. The unmasked target
    is one ``adain_with_stats`` with the folded moments
    (``blended_style_stats``), on every device: it equals the JAX package's
    per-style sum, ``sum_s w_s (sigma_s c_norm + mu_s) = (sum_s w_s sigma_s)
    c_norm + sum_s w_s mu_s``. The masked target is that sum per pixel."""
    if style_masks is not None and style_weights is not None:
        raise ValueError("style_masks and style_weights are mutually exclusive: "
                         "masks are per-pixel weights already")
    styles, weights = resolve_style_weights(style, style_weights)
    masks_f = None
    if style_masks is not None:
        masks_f = feature_masks(style_masks, content.shape[1:3],
                                len(styles)).to(content.device)
    (c_feat,) = vgg(content, (ENCODE_TAP,), precision=precision)
    cf = c_feat.float()
    if masks_f is None:
        mu_s, sigma_s = blended_style_stats(vgg, styles, weights, precision=precision)
        t = adain_with_stats(c_feat, mu_s, sigma_s).float()
    else:
        mu_c, sigma_c = channel_stats(c_feat)
        c_norm = (cf - mu_c) / sigma_c
        t = torch.zeros_like(c_norm)
        for i, s_img in enumerate(styles):
            (s_feat,) = vgg(s_img, (ENCODE_TAP,), precision=precision)
            mu_s, sigma_s = channel_stats(s_feat)
            t = t + masks_f[i][None, :, :, None] * (sigma_s * c_norm + mu_s)
    t = alpha * t + (1.0 - alpha) * cf
    return decoder(t.to(c_feat.dtype), precision)


# -- weights ------------------------------------------------------------------


def _decoder_keys() -> list:
    """The (weight key, bias key) of each conv of ``AdaINDecoder``, in order."""
    keys = [k for k in AdaINDecoder().state_dict() if k.endswith(".weight")]
    return [(k, k[: -len("weight")] + "bias") for k in keys]


def _expected_shapes() -> list:
    out, cin = [], 512
    for cout, _ in _DECODER_CFG:
        out.append((cout, cin, 3, 3))
        cin = cout
    return out


def _state_dict_from_convs(convs: Sequence[Tuple[np.ndarray, np.ndarray]]) -> StateDict:
    got = [tuple(w.shape) for w, _ in convs]
    if got != _expected_shapes():
        raise ValueError(f"decoder architecture mismatch: convs {got} vs the "
                         f"AdaIN decoder's {_expected_shapes()}")
    sd: StateDict = {}
    for (wk, bk), (w, b) in zip(_decoder_keys(), convs):
        sd[wk] = torch.from_numpy(np.array(w, np.float32))
        sd[bk] = torch.from_numpy(np.array(b, np.float32))
    return sd


def decoder_params_from_jax(tree: Mapping[str, Any]) -> StateDict:
    """The JAX package's decoder params ``{"convs": [{"w": HWIO, "b"}, ...]}``
    (numpy arrays) -> ``AdaINDecoder``'s state_dict (OIHW)."""
    return _state_dict_from_convs(
        [(np.asarray(c["w"], np.float32).transpose(3, 2, 0, 1), c["b"])
         for c in tree["convs"]])


def decoder_state_dict_from_torch(state_dict: Mapping[str, Any]) -> StateDict:
    """A torch AdaIN-decoder state_dict (the public decoders' Sequential, the
    port's own, any numbering) -> ``AdaINDecoder``'s state_dict, by order:
    each 4-D conv weight followed by its 1-D bias, shapes checked against
    the architecture; other entries are skipped."""
    convs, pending = [], None
    for key, val in state_dict.items():
        arr = np.asarray(val.detach().cpu().float().numpy() if hasattr(val, "detach")
                         else val)
        if arr.ndim == 4:
            if pending is not None:
                raise ValueError(f"two consecutive conv weights without a bias "
                                 f"between them (at {key!r})")
            pending = arr
        elif arr.ndim == 1 and pending is not None:
            if arr.shape[0] != pending.shape[0]:
                raise ValueError(f"bias {key!r} of length {arr.shape[0]} does not "
                                 f"match the conv's {pending.shape[0]} outputs")
            convs.append((pending, arr))
            pending = None
    if pending is not None:
        raise ValueError("trailing conv weight without a bias")
    return _state_dict_from_convs(convs)


def save_decoder_npz(state_dict: Mapping[str, torch.Tensor], path: str) -> None:
    """``AdaINDecoder``'s state_dict -> the JAX package's flat ``.npz``
    (``convs/<i>/w`` HWIO, ``convs/<i>/b``), which both packages load."""
    flat = {}
    for i, (wk, bk) in enumerate(_decoder_keys()):
        w = state_dict[wk].detach().cpu().float().numpy()
        flat[f"convs/{i}/w"] = np.ascontiguousarray(w.transpose(2, 3, 1, 0))
        flat[f"convs/{i}/b"] = state_dict[bk].detach().cpu().float().numpy()
    np.savez(path, **flat)


def load_decoder(path: str) -> StateDict:
    """Decoder weights as ``AdaINDecoder``'s state_dict from the JAX
    package's ``.npz``, or a torch ``.pth``/``.pt``/``.bin``: a public AdaIN
    decoder, the port's own ``torch.save`` of the state_dict, or a training
    checkpoint (bare, or under ``decoder``, ``model_state_dict`` or
    ``state_dict``). Orbax directories are not read."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            n = len(_DECODER_CFG)
            return decoder_params_from_jax(
                {"convs": [{"w": z[f"convs/{i}/w"], "b": z[f"convs/{i}/b"]}
                           for i in range(n)]})
    if path.endswith((".pth", ".pt", ".bin")):
        obj = torch.load(path, map_location="cpu", weights_only=True)
        for wrapper in ("decoder", "model_state_dict", "state_dict"):
            if isinstance(obj, Mapping) and isinstance(obj.get(wrapper), Mapping):
                obj = obj[wrapper]
        if not isinstance(obj, Mapping):
            raise ValueError(f"{path} holds no decoder state_dict")
        return decoder_state_dict_from_torch(obj)
    raise FileNotFoundError(
        f"no such decoder checkpoint: {path} (expected a .npz or .pth file; "
        "Orbax directories are not read)")


def make_decoder(state_dict: Optional[Mapping[str, torch.Tensor]], device) -> AdaINDecoder:
    """An ``AdaINDecoder`` on ``device``, channels_last, with ``state_dict``
    (None: PyTorch's default init from the global generator)."""
    dec = AdaINDecoder()
    if state_dict is not None:
        dec.load_state_dict(state_dict, strict=True)
    return dec.to(device, memory_format=torch.channels_last)
