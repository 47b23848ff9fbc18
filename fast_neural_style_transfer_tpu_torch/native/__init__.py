"""ctypes bindings for the host-pipeline kernels in ``fnst_host.cpp`` (the
JAX package's ``native/``), with their plain versions beside them.

The shared library is built with g++ on first use into ``build/host/`` at
the repository root, named by a digest of the source, the flags and the
host CPU (``-march=native`` code runs only where it was built), written
to a temporary name and renamed into place, so processes that build at
once never load a partial file. A failed build or load raises with the
compiler's output: there is no quiet fallback, as there is none for the
CUDA kernels (``ops/_build.py``).

- ``normalize_batch``: uint8 NHWC -> ImageNet-normalized float32, through
  a per-channel table of ``(v * (1/255) - mean) * (1/std)`` in float32;
  ``normalize_batch_plain`` is the same arithmetic in NumPy, within one
  ulp of it (the compiler may fuse the multiply-add). The true division
  ``v / 255`` of ``utils/image_io.py::normalize_image`` differs from both
  by up to a few hundred ulps where ``v / 255`` nears the mean.
- ``resize_bilinear``: uint8 HWC, half-pixel centres. The native kernel is
  a fixed 2-tap bilinear, which matches PIL only when enlarging: PIL's
  BILINEAR widens its support on reduction (antialiasing), so downscales
  take ``resize_bilinear_plain`` (PIL). That is the function's semantics,
  not a fallback: the result must not depend on whether the native
  library is in use.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from fast_neural_style_transfer_tpu_torch.utils.image_io import IMAGENET_MEAN, IMAGENET_STD

SOURCE = Path(__file__).resolve().parent / "fnst_host.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
CXX = "g++"
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]
ABI_VERSION = 1

_MEAN = np.ascontiguousarray(IMAGENET_MEAN, np.float32)
_STDINV = np.ascontiguousarray(1.0 / IMAGENET_STD, np.float32)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _host_cpu() -> str:
    """The host CPU's model and feature flags (what ``-march=native``
    compiles for), or the empty string where /proc/cpuinfo is absent."""
    try:
        with open("/proc/cpuinfo") as f:
            return "".join(line for line in f
                           if line.startswith(("model name", "flags")))[:4096]
    except OSError:
        return ""


def build() -> Path:
    """Compile ``fnst_host.cpp`` with ``CXX`` into ``BUILD_DIR`` (cached by
    digest); raises ``RuntimeError`` with the compiler's output if it
    cannot."""
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode() + _host_cpu().encode()
    ).hexdigest()[:16]
    out = BUILD_DIR / f"libfnst_host_{digest}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [CXX, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), "-lpthread"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"cannot build {SOURCE} with {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{CXX} failed for {SOURCE} (rc {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _bind(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.fnst_abi_version.restype = ctypes.c_int
    lib.fnst_abi_version.argtypes = []
    if lib.fnst_abi_version() != ABI_VERSION:
        raise RuntimeError(f"{path}: ABI version {lib.fnst_abi_version()}, "
                           f"expected {ABI_VERSION}")
    lib.fnst_normalize_u8_to_f32.restype = None
    lib.fnst_normalize_u8_to_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ]
    lib.fnst_resize_bilinear_u8.restype = None
    lib.fnst_resize_bilinear_u8.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
    ]
    return lib


def _load() -> ctypes.CDLL:
    """Build (if needed) and load the library, once per process."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(build())
        return _lib


def available() -> bool:
    """Whether the native library builds and loads on this host (the
    entry points raise where it does not)."""
    try:
        _load()
        return True
    except (RuntimeError, OSError):
        return False


def _check_images(a: np.ndarray, ndim: int) -> None:
    if not isinstance(a, np.ndarray) or a.dtype != np.uint8:
        raise TypeError(f"want a uint8 numpy array, got {getattr(a, 'dtype', type(a))}")
    if a.ndim != ndim or a.shape[-1] != 3:
        raise ValueError(f"want {'NHWC' if ndim == 4 else 'HWC'} with 3 channels, "
                         f"got shape {a.shape}")


def normalize_batch(u8: np.ndarray, *, n_threads: int = 4) -> np.ndarray:
    """(n, h, w, 3) uint8 -> ImageNet-normalized float32, on ``n_threads``
    host threads (the result does not depend on their number)."""
    _check_images(u8, 4)
    lib = _load()
    u8 = np.ascontiguousarray(u8)
    out = np.empty(u8.shape, np.float32)
    n, h, w, _ = u8.shape
    lib.fnst_normalize_u8_to_f32(
        u8.ctypes.data, out.ctypes.data, n, h, w,
        _MEAN.ctypes.data, _STDINV.ctypes.data, max(int(n_threads), 1))
    return out


def normalize_batch_plain(u8: np.ndarray) -> np.ndarray:
    """NumPy version of ``normalize_batch`` (within one float32 ulp)."""
    _check_images(u8, 4)
    return (u8.astype(np.float32) * np.float32(1.0 / 255.0) - _MEAN) * _STDINV


def resize_bilinear_plain(img: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """PIL's BILINEAR resize of (h, w, 3) uint8 to (dh, dw, 3)."""
    from PIL import Image

    return np.asarray(Image.fromarray(img).resize((dw, dh), Image.BILINEAR), np.uint8)


def resize_bilinear(img: np.ndarray, dh: int, dw: int, *, n_threads: int = 1) -> np.ndarray:
    """(h, w, 3) uint8 -> (dh, dw, 3) uint8, bilinear with half-pixel
    centres: the native kernel where both dims grow or stay, PIL where
    either shrinks (module docstring)."""
    _check_images(img, 3)
    if dh < 1 or dw < 1:
        raise ValueError(f"target size must be positive, got {(dh, dw)}")
    sh, sw, _ = img.shape
    if (sh, sw) == (dh, dw):
        return img
    if dh < sh or dw < sw:
        return resize_bilinear_plain(img, dh, dw)
    lib = _load()
    img = np.ascontiguousarray(img)
    out = np.empty((dh, dw, 3), np.uint8)
    lib.fnst_resize_bilinear_u8(img.ctypes.data, sh, sw, out.ctypes.data, dh, dw,
                                max(int(n_threads), 1))
    return out
