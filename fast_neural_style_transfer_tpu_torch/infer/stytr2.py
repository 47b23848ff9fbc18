"""StyTr² serving: a transformer stylizer with a cached style.

``TransformerStylizer`` is shaped like ``infer.adain.ArbitraryStylizer``:
``set_style_u8`` embeds and encodes the style once and caches what depends
on it alone (``models.stytr2.StyleMemory``: each decoder attention's keys
and values of ``encoder_s``'s output), the analogue of AdaIN's cached
moments; ``stylize_u8`` runs the uint8 round trip per content batch: u8 in,
[0, 1], reflect-pad to the bucket, patch embedding and CAPE, ``encoder_c``,
the cross-attention decoder, the AdaIN decoder, clamp to [0, 1], u8 out.
Padded tokens take part in attention and CAPE, as padded rows enter AdaIN's
moments.

Spans: ``stylize.copy_in`` / ``stylize.launch`` / ``stylize.copy_out`` as
the other stylizers', and inside the launch the stage spans
``stytr2.embed`` (patch embedding and CAPE), ``stytr2.encode``,
``stytr2.decode`` (the transformer decoder) and ``stytr2.cnn`` (the AdaIN
decoder), each with its device time (``utils.tracing.stage``). Counters,
always on: ``attention_launches`` and ``style_encodes``.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Union

import numpy as np
import torch

from fast_neural_style_transfer_tpu_torch.core.dtypes import canonical_compute_dtype, exact_f32
from fast_neural_style_transfer_tpu_torch.core.shapes import (
    indexed_device,
    pad_to_multiple_reflect,
    resolve_device,
)
from fast_neural_style_transfer_tpu_torch.models.stytr2 import PATCH, make_stytr2
from fast_neural_style_transfer_tpu_torch.infer.stylize import serve_u8
from fast_neural_style_transfer_tpu_torch.utils import tracing
from fast_neural_style_transfer_tpu_torch.utils.image_io import u8_to_unit, unit_to_u8


class TransformerStylizer:
    """StyTr² with a cached style; serves uint8 batches.

    ``params``: ``StyTr2``'s state_dict (``models.stytr2.load_stytr2``).
    ``precision``: "f32" (TF32 off on the card) or "bf16" (the transformer's
    weights held in bf16; attention on the flash backend only); "int8" is
    not served. ``bucket_multiple``: content is reflect-padded up to a
    multiple of it, itself a multiple of the 8-pixel patch. ``device``: None
    means the card. The model's sizes are ``params``' own.
    """

    def __init__(
        self,
        params: Mapping[str, Any],
        *,
        precision: str = "f32",
        bucket_multiple: int = 64,
        device: Optional[Union[str, torch.device]] = None,
    ):
        if precision == "int8":
            raise ValueError("StyTr² serves in 'f32' or 'bf16'; int8 is the flagship's only")
        if bucket_multiple % PATCH:
            raise ValueError(f"bucket_multiple must be a multiple of the {PATCH}-pixel patch "
                             f"(got {bucket_multiple})")
        self.device = indexed_device(resolve_device(device))
        self.precision = canonical_compute_dtype(precision)
        self.bucket_multiple = bucket_multiple
        exact_f32(self.device, self.precision)
        self.model = make_stytr2(params, self.device)
        dtype = self.precision.compute_dtype
        self.model.embedding.to(dtype)
        self.model.transformer.to(dtype)
        self.style_encodes = 0
        self._style = None

    @property
    def attention_launches(self) -> int:
        return self.model.counter.attention_launches

    @torch.inference_mode()
    def set_style(self, style_unit) -> "TransformerStylizer":
        """Embed and encode a [0, 1] NHWC (or HWC) style image, sides
        multiples of 8, once."""
        s = torch.as_tensor(np.asarray(style_unit, np.float32) if not torch.is_tensor(style_unit)
                            else style_unit, device=self.device)
        if s.dim() == 3:
            s = s[None]
        self._style = self.model.encode_style(s.float(), self.precision)
        self.style_encodes += 1
        return self

    def set_style_u8(self, style_u8) -> "TransformerStylizer":
        """``set_style`` from a raw uint8 HWC/NHWC image, reflect-padded to
        a multiple of 8."""
        a = np.asarray(style_u8)
        if a.dtype != np.uint8:
            raise TypeError(f"set_style_u8 wants uint8, got {a.dtype}")
        if a.ndim == 3:
            a = a[None]
        x = u8_to_unit(pad_to_multiple_reflect(torch.from_numpy(a), PATCH)[0])
        return self.set_style(x)

    def forward_unit(self, x_unit: torch.Tensor) -> torch.Tensor:
        """[0, 1] NHWC content, sides multiples of 8 -> [0, 1]-space pixels,
        unclamped, through the four stage spans."""
        m, p, dev = self.model, self.precision, self.device
        n, hh, ww = x_unit.shape[:3]
        count = lambda: m.counter.attention_launches  # noqa: E731
        with tracing.stage("stytr2.embed", dev, n=n, h=hh, w=ww):
            tokens, pos, grid = m.embed(x_unit, p)
        with tracing.stage("stytr2.encode", dev, count=count, n=n, h=hh, w=ww):
            tokens = m.encode(tokens, pos)
        with tracing.stage("stytr2.decode", dev, count=count, n=n, h=hh, w=ww):
            tokens = m.decode(tokens, pos, self._style)
        with tracing.stage("stytr2.cnn", dev, n=n, h=hh, w=ww):
            return m.cnn(tokens, grid, p)

    @torch.inference_mode()
    def stylize_u8(self, image_u8: np.ndarray) -> np.ndarray:
        """Raw uint8 (H,W,3)/(N,H,W,3) content in -> stylized uint8 out,
        with the cached style, by ``infer.stylize.serve_u8`` (padded up to
        the bucket and cropped back; its spans)."""
        if self._style is None:
            raise ValueError("no style set: call set_style(_u8) first")
        return serve_u8(image_u8, self.device, self.bucket_multiple,
                        lambda x: [unit_to_u8(self.forward_unit(u8_to_unit(x)))])
