"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/*.cu`` file exports plain ``extern "C"`` functions, so the
shared library needs no PyTorch headers and builds in seconds. The library
goes to ``build/kernels/`` at the repository root, named by a hash of the
sources and flags, and is built on first use. A failed build raises.
The first ``load`` of a process of a source of ``TOGETHER`` (the stylizers'
and training's kernels) loads all of them at once (``load_all``: their nvcc
runs start together), so a path that needs two kernels waits for the
slowest build, not for their sum; another source (AdaAttN's moment
attention) is built alone, by the path that needs it. One source is built
once per process. ``on_card`` calls an entry point on the card that
holds its tensors. ``counted`` gives a kernel wrapper its launch counters
and lists it in ``COUNTED``, where every reader of them finds it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
# the sources the stylizers, the AdaIN paths and training load together
TOGETHER = ("instance_norm", "conv_same_bwd", "reflect_pad", "conv_to_rgb")
# every source of the package
SOURCES = TOGETHER + ("moment_attention",)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()  # guards _locks
_locks: Dict[str, threading.Lock] = {}  # one per source
_libs: Dict[str, ctypes.CDLL] = {}
# per source: {"seconds": float, "log": str (nvcc's -Xptxas -v report)}
build_info: Dict[str, dict] = {}


def find_nvcc() -> str:
    """The toolkit PyTorch itself would build with (CUDA_HOME, CUDA_PATH,
    nvcc on PATH, or the toolkit's default location)."""
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if nvcc is None or not os.path.isfile(nvcc):
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return nvcc


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` into a shared library (cached by hash)."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}_{digest}.so"
    if out.exists():
        build_info.setdefault(name, {"seconds": 0.0, "log": "(cached)"})
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {src} (rc {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
    build_info[name] = {"seconds": seconds, "log": proc.stdout + proc.stderr}
    return out


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; one CDLL per process.
    A source of ``TOGETHER`` not loaded yet loads every one of them at once."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    return load_all(TOGETHER if name in TOGETHER else (name,))[name]


def _load_one(name: str) -> ctypes.CDLL:
    with _lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _libs[name] = lib
        return lib


def load_all(names: Sequence[str]) -> Dict[str, ctypes.CDLL]:
    """Load several sources, their nvcc runs started together."""
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        return dict(zip(names, pool.map(_load_one, names)))


def on_card(device: torch.device, fn: Callable, *args) -> int:
    """Call the library's ``fn`` with the CUDA runtime's current device set
    to ``device``, the card that holds the tensors, and that card's current
    stream as the last argument: the runtime launches on its current
    device, whichever card the pointers are on."""
    with torch.cuda.device(device):
        return fn(*args, torch.cuda.current_stream(device).cuda_stream)


# every kernel wrapper with launch counters, as ``counted`` made them
COUNTED: list = []


def counted(fn: Callable, **by: Sequence[str]) -> None:
    """Give the kernel wrapper ``fn`` its launch counters, all 0:
    ``fn.launches`` and, for each ``by`` name, a dict
    ``fn.launches_by_<name>`` over its keys. ``COUNTED`` lists ``fn``."""
    fn.launches = 0
    for name, keys in by.items():
        setattr(fn, f"launches_by_{name}", dict.fromkeys(keys, 0))
    COUNTED.append(fn)
