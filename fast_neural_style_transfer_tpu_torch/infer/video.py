"""Video stylization with frozen IN statistics (the JAX package's
``infer/video.py``).

Stylized frame by frame, per-frame instance norm makes a clip flicker:
every IN site re-normalizes each frame with its own spatial moments, so a
small local change shifts the tone of the whole frame. ``VideoStylizer``
captures every site's (mean, var) from one reference frame
(``TransformerNet.forward(return_stats=True)``) and normalizes all frames
with those moments, or with ``stats_blend * ref + (1 - stats_blend) * own``
(``in_stats=...``). On the card both run the IN forward kernel's capture and
inject modes (``ops/norm.py``); at blend 1 the inject kernel takes no
statistics pass. Otherwise this is the ``Stylizer`` u8 path: frames
reflect-padded to a shape bucket, batched, normalized and de-normalized on
the device, uint8 both ways.

IO needs no codecs: frame directories (natural sort) and animated GIFs
(PIL) in, a frame directory or a GIF out.
"""

from __future__ import annotations

import os
import re
from typing import Any, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from fast_neural_style_transfer_tpu_torch.core.dtypes import canonical_compute_dtype
from fast_neural_style_transfer_tpu_torch.core.shapes import pad_to_multiple_reflect
from fast_neural_style_transfer_tpu_torch.infer.stylize import Stylizer
from fast_neural_style_transfer_tpu_torch.models.transformer import bake_style, num_styles
from fast_neural_style_transfer_tpu_torch.utils.image_io import network_to_u8, u8_to_network

_FRAME_EXTS = (".png", ".jpg", ".jpeg")


def _natural_key(name: str):
    """Sort key splitting digit runs so frame_2 < frame_10."""
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", name)]


class VideoStylizer:
    """Stylize frame sequences with IN statistics frozen to a reference frame.

    ``stats_blend``: 1.0 freezes every IN site's moments to the reference
    frame's; 0.0 is the plain per-frame stylizer; values between blend.
    ``stabilize=False`` skips capture (the A/B baseline). One instance
    serves one clip: the reference is captured from frame 0 on first use
    (or by ``set_reference``) and kept; call ``reset_reference()`` before
    another clip. ``params``, ``precision`` and ``device`` as for
    ``Stylizer`` (None: the card).
    """

    def __init__(
        self,
        params: Mapping[str, Any],
        *,
        precision: str = "f32",
        bucket_multiple: int = 64,
        stats_blend: float = 1.0,
        stabilize: bool = True,
        device: Optional[Union[str, torch.device]] = None,
    ):
        if not 0.0 <= stats_blend <= 1.0:
            raise ValueError(f"stats_blend must be in [0, 1], got {stats_blend}")
        canonical_compute_dtype(precision)  # f32 or bf16: int8 has no IN statistics path
        sty = Stylizer(params, precision=precision, bucket_multiple=bucket_multiple,
                       device=device)
        self.net, self.device, self.precision = sty.net, sty.device, sty.precision
        self.bucket_multiple = bucket_multiple
        self.stats_blend = float(stats_blend)
        self.stabilize = stabilize
        self._stats: Optional[list] = None

    @classmethod
    def from_checkpoint(cls, path: str, *, style=None, **kw) -> "VideoStylizer":
        """Load a checkpoint; a multi-style one needs ``style`` (an index or
        a blend vector, baked with ``bake_style``), a single-style one
        refuses it."""
        params = Stylizer.load_params(path)
        if num_styles(params) > 1:
            if style is None:
                raise ValueError(
                    f"{path} is a multi-style checkpoint: pass style=<index "
                    "or blend vector>")
            params = bake_style(params, style)
        elif style is not None:
            raise ValueError(f"style={style!r} given but {path} is single-style")
        return cls(params, **kw)

    # -- stabilization -------------------------------------------------------

    def _pad(self, x_u8: np.ndarray) -> Tuple[torch.Tensor, Tuple[int, int]]:
        x_u8 = np.asarray(x_u8)
        if x_u8.dtype != np.uint8:
            raise TypeError(f"VideoStylizer wants uint8 frames, got {x_u8.dtype}")
        x = torch.from_numpy(np.ascontiguousarray(x_u8)).to(self.device)
        return pad_to_multiple_reflect(x, self.bucket_multiple)

    @torch.inference_mode()
    def set_reference(self, frame_u8: np.ndarray) -> None:
        """Capture the IN statistics of one (H, W, 3) uint8 reference frame;
        its (1, C, 1, 1) moments broadcast over any later frame batch of the
        same bucket."""
        padded, _ = self._pad(np.asarray(frame_u8)[None])
        _, self._stats = self.net(u8_to_network(padded), self.precision,
                                  return_stats=True)

    def reset_reference(self) -> None:
        """Drop the reference statistics, so the next clip captures its own
        frame 0."""
        self._stats = None

    # -- forward -------------------------------------------------------------

    def _forward_u8(self, x_u8: torch.Tensor) -> torch.Tensor:
        x = u8_to_network(x_u8)
        if self.stabilize:
            y = self.net(x, self.precision, in_stats=self._stats,
                         stats_blend=self.stats_blend)
        else:
            y = self.net(x, self.precision)
        return network_to_u8(y)

    @torch.inference_mode()
    def raw_forward(self, frames_u8: torch.Tensor) -> torch.Tensor:
        """Benchmarking hook: the frozen-statistics u8 -> u8 device program
        at an already bucket-aligned shape; ``set_reference`` first."""
        if self._stats is None:
            raise RuntimeError("raw_forward needs set_reference() first")
        if frames_u8.ndim != 4 or frames_u8.dtype != torch.uint8:
            raise TypeError("raw_forward wants a uint8 NHWC frame batch")
        h, w = int(frames_u8.shape[1]), int(frames_u8.shape[2])
        if h % self.bucket_multiple or w % self.bucket_multiple:
            raise ValueError(
                f"raw_forward needs bucket-aligned H/W (multiple of "
                f"{self.bucket_multiple}); got {h}x{w}")
        return self._forward_u8(frames_u8.to(self.device))

    @torch.inference_mode()
    def stylize_frames(self, frames_u8: np.ndarray, *,
                       batch_size: int = 8) -> np.ndarray:
        """(N, H, W, 3) uint8 frames -> (N, H, W, 3) stylized uint8.

        Captures the reference from frame 0 on first use (unless
        ``set_reference`` was called, or ``stabilize=False``). A short last
        chunk repeats its last frame up to ``batch_size``, so every batch of
        the clip has one shape."""
        frames_u8 = np.asarray(frames_u8)
        if frames_u8.ndim != 4:
            raise ValueError(f"expected (N, H, W, 3) frames, got {frames_u8.shape}")
        if self.stabilize and self._stats is None:
            self.set_reference(frames_u8[0])
        out = np.empty_like(frames_u8)
        n = frames_u8.shape[0]
        for lo in range(0, n, batch_size):
            chunk = frames_u8[lo:lo + batch_size]
            pad_n = batch_size - chunk.shape[0]
            if pad_n and n > batch_size:
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad_n, axis=0)])
            padded, (h, w) = self._pad(chunk)
            y = self._forward_u8(padded)[:, :h, :w, :].cpu().numpy()
            out[lo:lo + batch_size] = y[: out[lo:lo + batch_size].shape[0]]
        return out


def flicker_score(frames_u8: np.ndarray, mask: Optional[np.ndarray] = None) -> float:
    """Mean absolute inter-frame difference of a clip (uint8 scale); 0 for
    identical frames. On the whole frame it counts content motion too;
    ``mask``, an (H, W) bool array of static pixels (True = include),
    confines it to pixels where any change is flicker."""
    f = np.asarray(frames_u8, np.float32)
    if f.shape[0] < 2:
        return 0.0
    d = np.abs(np.diff(f, axis=0))
    if mask is not None:
        mask = np.asarray(mask, bool)
        if mask.shape != f.shape[1:3]:
            raise ValueError(
                f"mask shape {mask.shape} != frame spatial shape {f.shape[1:3]}")
        d = d[:, mask, :]
    return float(d.mean())


# -- IO (frame directories and GIFs; no codecs) -------------------------------


def read_frames(path: str, *, size: Optional[Tuple[int, int]] = None,
                max_frames: Optional[int] = None) -> np.ndarray:
    """A clip as (N, H, W, 3) uint8 from a frame directory (``.png``/
    ``.jpg``, natural sort, so frame_2 precedes frame_10) or an animated
    GIF. ``size`` = (H, W) resize."""
    from PIL import Image, ImageSequence

    frames: List[np.ndarray] = []
    if os.path.isdir(path):
        names = sorted((f for f in os.listdir(path) if f.lower().endswith(_FRAME_EXTS)),
                       key=_natural_key)
        if not names:
            raise FileNotFoundError(f"no frames under {path}")
        for name in names[:max_frames]:
            with Image.open(os.path.join(path, name)) as im:
                frames.append(_to_rgb(im, size))
    else:
        with Image.open(path) as im:
            for i, frame in enumerate(ImageSequence.Iterator(im)):
                if max_frames is not None and i >= max_frames:
                    break
                frames.append(_to_rgb(frame, size))
    shapes = {f.shape for f in frames}
    if len(shapes) > 1:
        raise ValueError(f"frames disagree on shape ({sorted(shapes)}); pass size=(H, W)")
    return np.stack(frames)


def _to_rgb(im, size) -> np.ndarray:
    from PIL import Image

    im = im.convert("RGB")
    if size is not None:
        im = im.resize((size[1], size[0]), Image.BILINEAR)
    return np.asarray(im, np.uint8)


def write_frames(frames_u8: np.ndarray, path: str, *, fps: float = 12.0) -> None:
    """Write (N, H, W, 3) uint8 to ``path``: a ``.gif`` animation, or a
    directory of ``frame_%05d.png``."""
    from PIL import Image

    if path.lower().endswith(".gif"):
        imgs = [Image.fromarray(f) for f in np.asarray(frames_u8)]
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        imgs[0].save(path, save_all=True, append_images=imgs[1:],
                     duration=max(1, int(round(1000.0 / fps))), loop=0)
    else:
        os.makedirs(path, exist_ok=True)
        for i, f in enumerate(np.asarray(frames_u8)):
            Image.fromarray(f).save(os.path.join(path, f"frame_{i:05d}.png"))


def stylize_video_file(
    model_path: str,
    content_path: str,
    output_path: str,
    *,
    size: Optional[Tuple[int, int]] = None,
    precision: str = "f32",
    style=None,
    stats_blend: float = 1.0,
    stabilize: bool = True,
    batch_size: int = 8,
    fps: float = 12.0,
    max_frames: Optional[int] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> dict:
    """Read a clip, stylize it (stabilized), write it. Returns a summary:
    frame count and size, and the flicker scores of input and output."""
    frames = read_frames(content_path, size=size, max_frames=max_frames)
    vs = VideoStylizer.from_checkpoint(
        model_path, style=style, precision=precision, stats_blend=stats_blend,
        stabilize=stabilize, device=device)
    out = vs.stylize_frames(frames, batch_size=batch_size)
    write_frames(out, output_path, fps=fps)
    return {
        "frames": int(frames.shape[0]),
        "height": int(frames.shape[1]),
        "width": int(frames.shape[2]),
        "input_flicker": flicker_score(frames),
        "output_flicker": flicker_score(out),
        "stabilized": bool(stabilize),
        "stats_blend": float(stats_blend),
        "device": str(vs.device),
        "output": output_path,
    }
