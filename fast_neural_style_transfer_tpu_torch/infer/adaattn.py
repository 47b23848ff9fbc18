"""AdaAttN serving: an attention stylizer with a cached style.

``AttentionalStylizer`` is shaped like ``infer.stytr2.TransformerStylizer``:
``set_style_u8`` encodes the style once to relu5_1, in float32 at every
precision (once per style, so its cost is set-up; the keys and values of
every request's attention then carry no bf16 error of the style's own),
and caches what depends on it alone (``models.adaattn.AdaAttN.
style_cache``: each site's sampled ``g(K_s)`` and the moments' values of
``h(F_s^l)``, stored in the compute dtype); ``stylize_u8`` runs
the uint8 round trip per content batch through ``infer.stylize.serve_u8``:
u8 in, ImageNet-normalized, reflect-padded to the bucket, VGG19 to relu5_1,
the keys and queries, the three moment attentions, the merge and the
decoder, clamp to [0, 1], u8 out. Padded pixels enter the keys' instance
norms and the attention, as padded rows enter AdaIN's moments. Eager, not
graphed: the stage spans time each stage with events at its bounds.

Spans: ``stylize.copy_in`` / ``stylize.launch`` / ``stylize.copy_out`` as
the other stylizers', and inside the launch the stage spans
``adaattn.encode`` (VGG19 to relu5_1), ``adaattn.keys`` (the key builder
and the query projections), ``adaattn.attend`` (the three moment
attentions, their launches as ``ops``) and ``adaattn.decode`` (merge conv
and decoder), each with its device time (``utils.tracing.stage``).
Counters, always on: ``attention_launches`` and ``style_encodes``; the
kernel's own ``ops.cuda_moment_attention.moment_attention.launches``.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Union

import numpy as np
import torch

from fast_neural_style_transfer_tpu_torch.core.dtypes import (
    Precision,
    canonical_compute_dtype,
)
from fast_neural_style_transfer_tpu_torch.core.shapes import (
    indexed_device,
    pad_to_multiple_reflect,
    resolve_device,
)
from fast_neural_style_transfer_tpu_torch.infer.stylize import serve_u8
from fast_neural_style_transfer_tpu_torch.models.adaattn import GRID, LEVELS, make_adaattn
from fast_neural_style_transfer_tpu_torch.models.vgg_weights import make_vgg
from fast_neural_style_transfer_tpu_torch.utils import tracing
from fast_neural_style_transfer_tpu_torch.utils.image_io import (
    normalize_image,
    u8_to_network,
    unit_to_u8,
)


class AttentionalStylizer:
    """AdaAttN with a cached style; serves uint8 batches.

    ``params``: ``AdaAttN``'s state_dict (``models.adaattn.load_adaattn``);
    ``vgg_params``: VGG19's (``models.vgg_weights.resolve_params``).
    ``precision``: "f32" (the CPU only: the moment-attention kernel has no
    float32 variant, and its plain version serves no card) or "bf16" (on a
    card the moment attention runs on its kernel); "int8" is not served.
    ``bucket_multiple``: content is reflect-padded up to a multiple of it,
    itself a multiple of relu5_1's 16-pixel grid. ``device``: None means the
    card.
    """

    def __init__(
        self,
        params: Mapping[str, Any],
        vgg_params: Mapping[str, Any],
        *,
        precision: str = "f32",
        bucket_multiple: int = 64,
        device: Optional[Union[str, torch.device]] = None,
    ):
        if precision == "int8":
            raise ValueError("AdaAttN serves in 'f32' or 'bf16'; int8 is the flagship's only")
        if bucket_multiple % GRID:
            raise ValueError(f"bucket_multiple must be a multiple of relu5_1's {GRID}-pixel "
                             f"grid (got {bucket_multiple})")
        self.device = indexed_device(resolve_device(device))
        self.precision = canonical_compute_dtype(precision)
        if self.device.type == "cuda" and self.precision.compute_dtype != torch.bfloat16:
            raise ValueError("AdaAttN serves 'bf16' on a card: the moment-attention kernel "
                             "has no float32 variant ('f32' runs on the CPU)")
        self.bucket_multiple = bucket_multiple
        self.model = make_adaattn(params, self.device)
        self.vgg = make_vgg(vgg_params, self.device)
        self.style_encodes = 0
        self._style = None

    @property
    def attention_launches(self) -> int:
        return self.model.counter.attention_launches

    @torch.inference_mode()
    def set_style(self, style_net) -> "AttentionalStylizer":
        """Encode a network-space NHWC (or HWC) style image, sides multiples
        of 16, once, in float32 (cuDNN's TF32 convolutions where the process
        allows them, PyTorch's default at bf16)."""
        s = torch.as_tensor(np.asarray(style_net, np.float32) if not torch.is_tensor(style_net)
                            else style_net, device=self.device)
        if s.dim() == 3:
            s = s[None]
        feats = self.vgg(s.float(), LEVELS, precision=Precision.f32())
        self._style = self.model.style_cache(feats, self.precision)
        self.style_encodes += 1
        return self

    def set_style_u8(self, style_u8) -> "AttentionalStylizer":
        """``set_style`` from a raw uint8 HWC/NHWC image, reflect-padded to a
        multiple of 16."""
        a = np.asarray(style_u8)
        if a.dtype != np.uint8:
            raise TypeError(f"set_style_u8 wants uint8, got {a.dtype}")
        if a.ndim == 3:
            a = a[None]
        return self.set_style(pad_to_multiple_reflect(torch.from_numpy(normalize_image(a)),
                                                      GRID)[0])

    def forward_net(self, x_net: torch.Tensor) -> torch.Tensor:
        """Network-space NHWC content, sides multiples of 16 -> [0, 1]-space
        pixels, unclamped, through the four stage spans."""
        m, p, dev = self.model, self.precision, self.device
        n, hh, ww = x_net.shape[:3]
        with tracing.stage("adaattn.encode", dev, n=n, h=hh, w=ww):
            feats = self.vgg(x_net, LEVELS, precision=p)
        with tracing.stage("adaattn.keys", dev, n=n, h=hh, w=ww):
            keys = m.keys(feats, p)
        with tracing.stage("adaattn.attend", dev, count=lambda: m.counter.attention_launches,
                           n=n, h=hh, w=ww):
            outs = m.attend(keys, self._style, feats)
        with tracing.stage("adaattn.decode", dev, n=n, h=hh, w=ww):
            return m.decode(outs, p)

    @torch.inference_mode()
    def stylize_u8(self, image_u8: np.ndarray) -> np.ndarray:
        """Raw uint8 (H,W,3)/(N,H,W,3) content in -> stylized uint8 out,
        with the cached style, by ``infer.stylize.serve_u8`` (padded up to
        the bucket and cropped back; its spans)."""
        if self._style is None:
            raise ValueError("no style set: call set_style(_u8) first")
        return serve_u8(image_u8, self.device, self.bucket_multiple,
                        lambda x: [unit_to_u8(self.forward_net(u8_to_network(x)))])
