"""AdaIN serving: cached-style arbitrary stylization and bulk directory jobs
(the JAX package's ``infer/adain.py``).

``ArbitraryStylizer`` encodes the style image(s) once into the
interpolation-folded (mu, sigma) pair (``models.adain.blended_style_stats``)
and then runs a uint8 round trip per content batch on the device: u8 in,
normalize, VGG encode to relu4_1, re-normalize to the cached moments (the IN
forward kernel on the card, with a (C,) affine gamma = sigma, beta = mu),
blend by ``alpha``, decode, de-normalize, u8 out. Bulk jobs run on
``infer.stylize.pipeline_directory``. ``sharding`` (a ``ReplicaPlan``)
replicates the decoder, VGG and the cached style on its devices and
splits a batch over them as ``infer.stylize.Stylizer`` does; AdaIN's
statistics are per sample, so nothing crosses devices.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from fast_neural_style_transfer_tpu_torch.core.dtypes import canonical_compute_dtype, exact_f32
from fast_neural_style_transfer_tpu_torch.core.shapes import (
    indexed_device,
    pad_to_multiple_reflect,
    resolve_device,
)
from fast_neural_style_transfer_tpu_torch.infer.graphs import ForwardGraphs, GraphCounts, engages
from fast_neural_style_transfer_tpu_torch.infer.stylize import serve_u8
from fast_neural_style_transfer_tpu_torch.models.adain import (
    ENCODE_TAP,
    adain_with_stats,
    blended_style_stats,
    load_decoder,
    make_decoder,
)
from fast_neural_style_transfer_tpu_torch.models.vgg_weights import make_vgg, resolve_params
from fast_neural_style_transfer_tpu_torch.parallel.mesh import make_mesh_plan, place_on_data_axis
from fast_neural_style_transfer_tpu_torch.utils.color import luminance_transfer
from fast_neural_style_transfer_tpu_torch.utils.image_io import (
    mean_std,
    network_to_u8,
    normalize_image,
    u8_to_network,
)


class ArbitraryStylizer(GraphCounts):
    """Decoder + frozen VGG with a cached style; serves uint8 batches.

    ``decoder_params``: ``AdaINDecoder``'s state_dict (``load_decoder``,
    ``decoder_params_from_jax``); ``vgg_params``: VGG19's (``resolve_params``).
    ``device``: None means the card. ``precision``: "f32" (TF32 off on the
    card) or "bf16". ``preserve_color``: "off" or "luma" (stylized luminance,
    content chrominance); "match" re-colors the style per content and
    cannot use a cached style. ``bucket_multiple``: content is reflect-padded
    up to a multiple of it, and the padded rows enter the AdaIN moments.
    ``sharding``: a ``ReplicaPlan``, whose first device is ``device``: a
    replica on each of its devices, and a batch whose leading dim divides
    its degree split over them.

    ``stylize_u8`` replays a CUDA graph per (rows, height, width, alpha)
    where ``infer/graphs.py::engages`` (as ``infer.stylize.Stylizer``);
    ``set_style`` drops the graphs, which read the cached style.
    """

    def __init__(
        self,
        decoder_params: Mapping[str, Any],
        vgg_params: Mapping[str, Any],
        *,
        precision: str = "f32",
        sharding: Optional[Any] = None,
        bucket_multiple: int = 64,
        preserve_color: str = "off",
        device: Optional[Union[str, torch.device]] = None,
    ):
        if preserve_color not in ("off", "luma"):
            raise ValueError(
                f"preserve_color must be 'off' or 'luma' for serving "
                f"(got {preserve_color!r}); 'match' is per-content and "
                "defeats the cached style")
        if sharding is not None and device is not None and (
                indexed_device(resolve_device(device)) != sharding.device):
            raise ValueError(f"device {device} is not the plan's first device "
                             f"{sharding.device}")
        self.sharding = sharding
        self.device = indexed_device(
            resolve_device(device if sharding is None else sharding.device))
        self.precision = canonical_compute_dtype(precision)
        self.preserve_color = preserve_color
        self.bucket_multiple = bucket_multiple
        exact_f32(self.device, self.precision)
        self.decoder = make_decoder(decoder_params, self.device).eval()
        self.vgg = make_vgg(vgg_params, self.device)
        # (decoder, vgg) on every device of the plan
        self._replicas = {self.device: (self.decoder, self.vgg)}
        for d in (sharding.devices if sharding is not None else ()):
            if d not in self._replicas:
                exact_f32(d, self.precision)
                self._replicas[d] = (make_decoder(decoder_params, d).eval(),
                                     make_vgg(vgg_params, d))
        self._style: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._styles: dict = {}  # the cached style on every device of the plan
        if engages(self.device, sharding=sharding):
            self._graphs = ForwardGraphs()

    @torch.inference_mode()
    def set_style(self, style, style_weights=None) -> "ArbitraryStylizer":
        """Encode network-space NHWC style image(s) once (arrays or
        tensors); a list interpolates with convex ``style_weights``."""
        styles = list(style) if isinstance(style, (list, tuple)) else [style]
        styles = [torch.as_tensor(np.asarray(s, np.float32) if not torch.is_tensor(s) else s,
                                  device=self.device) for s in styles]
        self._style = blended_style_stats(self.vgg, styles, style_weights,
                                          precision=self.precision)
        self._styles = {d: tuple(t.to(d) for t in self._style) for d in self._replicas}
        if self._graphs is not None:
            self._graphs.clear()
        return self

    def set_style_u8(self, style_u8, style_weights=None) -> "ArbitraryStylizer":
        """``set_style`` from raw uint8 HWC/NHWC image(s), reflect-padded to
        a multiple of 8 (only their channel statistics are used)."""
        styles = list(style_u8) if isinstance(style_u8, (list, tuple)) else [style_u8]
        net = []
        for s in styles:
            a = np.asarray(s)
            if a.dtype != np.uint8:
                raise TypeError(f"set_style_u8 wants uint8, got {a.dtype}")
            if a.ndim == 3:
                a = a[None]
            net.append(pad_to_multiple_reflect(torch.from_numpy(normalize_image(a)), 8)[0])
        return self.set_style(net, style_weights)

    def _u8_roundtrip(self, x_u8: torch.Tensor, alpha: float) -> torch.Tensor:
        """One chunk, on its device's replica."""
        decoder, vgg = self._replicas[x_u8.device]
        x = u8_to_network(x_u8)
        (c_feat,) = vgg(x, (ENCODE_TAP,), precision=self.precision)
        mu_s, sigma_s = self._styles[x_u8.device]
        t = adain_with_stats(c_feat, mu_s, sigma_s)
        if alpha != 1.0:
            t = (alpha * t.float() + (1.0 - alpha) * c_feat.float()).to(c_feat.dtype)
        y = decoder(t, self.precision)
        if self.preserve_color == "luma":
            mean, std = mean_std(y.device)
            y01 = luminance_transfer(y.float() * std + mean, x * std + mean)
            y = (y01 - mean) / std
        return network_to_u8(y)

    @torch.inference_mode()
    def stylize_u8(self, image_u8: np.ndarray, *, alpha: float = 1.0) -> np.ndarray:
        """Raw uint8 (H,W,3)/(N,H,W,3) content in -> stylized uint8 out,
        with the cached style, by ``infer.stylize.serve_u8`` (padded up to
        the bucket and cropped back; its spans)."""
        if self._style is None:
            raise ValueError("no style set: call set_style(_u8) first")
        alpha = float(alpha)
        return serve_u8(image_u8, self.device, self.bucket_multiple,
                        lambda x: [self._u8_roundtrip(c, alpha)
                                   for c in place_on_data_axis(self.sharding, x)],
                        self._graphs, (alpha,))


def stylize_directory_arbitrary(
    decoder_path: str,
    content_dir: str,
    output_dir: str,
    style_paths,
    *,
    style_weights=None,
    alpha: float = 1.0,
    vgg_weights: Optional[str] = None,
    size: Optional[Tuple[int, int]] = None,
    batch_size: int = 16,
    precision: str = "f32",
    num_workers: int = 8,
    data_parallel: bool = False,
    skip_bad_images: bool = False,
    preserve_color: str = "off",
    device: Optional[Union[str, torch.device]] = None,
) -> list:
    """Stylize every image under ``content_dir`` with one arbitrary style
    (or an interpolated set), encoded once for the job: the AdaIN
    counterpart of ``infer.stylize.stylize_directory`` (``data_parallel``
    as there)."""
    from fast_neural_style_transfer_tpu_torch.infer.stylize import pipeline_directory
    from fast_neural_style_transfer_tpu_torch.utils.image_io import (
        decode_image,
        scan_image_files,
    )

    sharding = None
    if data_parallel:
        plan = make_mesh_plan(device=device)
        plan.check_batch(batch_size)
        sharding = plan.batch_sharding
    styler = ArbitraryStylizer(
        load_decoder(decoder_path), resolve_params(vgg_weights),
        precision=precision, preserve_color=preserve_color,
        device=None if sharding else device, sharding=sharding)
    paths = list(style_paths) if isinstance(style_paths, (list, tuple)) else [style_paths]
    styler.set_style_u8([decode_image(p) for p in paths], style_weights)
    return pipeline_directory(
        lambda b: styler.stylize_u8(b, alpha=alpha),
        scan_image_files(content_dir), content_dir, output_dir,
        size=size, batch_size=batch_size, num_workers=num_workers,
        skip_bad_images=skip_bad_images,
    )
