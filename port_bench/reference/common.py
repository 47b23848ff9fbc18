"""Image conventions and layers shared by the references, written out in
plain torch: ImageNet normalization, the u8 round trip, reflect-padded
convolutions, instance norm with its affine, and the int8 rounding of the
lower-precision control."""

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
IN_EPS = 1e-5


@contextlib.contextmanager
def float32_math(tf32: bool = False):
    """Real float32 on the card (TF32 off for convolutions and matmuls), or
    TF32 where ``tf32`` (the training control); restored on exit."""
    old = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


def to_network(x_u8_nhwc: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC -> float32 NCHW in ImageNet-normalized space."""
    x = x_u8_nhwc.permute(0, 3, 1, 2).float() / 255.0
    mean = torch.tensor(MEAN, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(STD, device=x.device).view(1, 3, 1, 1)
    return (x - mean) / std


def to_u8(y_nchw: torch.Tensor) -> torch.Tensor:
    """Network-space float NCHW -> uint8 NHWC: de-normalize, clip to [0, 1],
    scale, round half up."""
    mean = torch.tensor(MEAN, device=y_nchw.device).view(1, 3, 1, 1)
    std = torch.tensor(STD, device=y_nchw.device).view(1, 3, 1, 1)
    y = torch.clamp(y_nchw.float() * std + mean, 0.0, 1.0)
    return torch.floor(y * 255.0 + 0.5).to(torch.uint8).permute(0, 2, 3, 1)


def pad_to_bucket(img: np.ndarray, multiple: int) -> np.ndarray:
    """Pad one HWC image at the bottom and right up to the next multiple of
    ``multiple`` (at least 4), by reflection, or by repeating the edge where
    a pad is not smaller than the side, as a server that buckets does."""
    h, w, _ = img.shape
    ph = -(-max(h, 4) // multiple) * multiple
    pw = -(-max(w, 4) // multiple) * multiple
    if (ph, pw) == (h, w):
        return img
    mode = "reflect" if (ph - h < h and pw - w < w) else "edge"
    return np.pad(img, ((0, ph - h), (0, pw - w), (0, 0)), mode=mode)


def reflect_conv(x, w, b, stride: int = 1, conv=F.conv2d):
    """Reflection pad k // 2, then a valid convolution."""
    p = w.shape[-1] // 2
    if p:
        x = F.pad(x, (p, p, p, p), mode="reflect")
    return conv(x, w, b, stride=stride)


def instance_norm(x, gamma, beta, relu: bool = False):
    """Per-(sample, channel) mean and biased variance over H and W, then the
    affine; optionally ReLU."""
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = (x - mean).square().mean(dim=(2, 3), keepdim=True)
    y = (x - mean) * torch.rsqrt(var + IN_EPS) * gamma.view(1, -1, 1, 1) + beta.view(1, -1, 1, 1)
    return torch.relu(y) if relu else y


def _int8(t: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(t / scale), -127, 127)


def int8_conv2d(x, w, b, stride: int = 1, padding: int = 0):
    """A convolution computed in int8: weights rounded to int8 with one scale
    per output channel, the input with one scale for the tensor (its
    largest magnitude over 127), the integer products summed in float32,
    then rescaled."""
    ws = torch.clamp(w.abs().amax(dim=(1, 2, 3)), min=1e-12) / 127.0
    xs = torch.clamp(x.abs().amax(), min=1e-12) / 127.0
    y = F.conv2d(_int8(x, xs), _int8(w, ws.view(-1, 1, 1, 1)), None,
                 stride=stride, padding=padding)
    y = y * (xs * ws.view(1, -1, 1, 1))
    return y if b is None else y + b.view(1, -1, 1, 1)
