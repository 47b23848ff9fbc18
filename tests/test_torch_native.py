"""The port's host library (``native/``) against the JAX package's.

- ``normalize_batch`` is bit-equal to JAX's ``native.normalize_batch`` on
  the same uint8 batch (the same source built with the same flags) and
  within 1 float32 ulp of its plain NumPy version; the 1- and 8-thread
  results are bit-equal.
- An upscale through ``resize_bilinear`` is bit-equal to JAX's native
  upscale; a downscale is PIL's, bit for bit, in both packages.
- The library builds into ``build/host/``; a compiler that does not exist
  raises (there is no fallback).
"""

import os
import threading

import numpy as np
import pytest
from PIL import Image

from fast_neural_style_transfer_tpu import native as jax_native
from fast_neural_style_transfer_tpu_torch import native


def test_builds_into_build_host():
    assert native.available()
    path = native.build()
    assert path.parent == native.BUILD_DIR
    assert native.BUILD_DIR.parts[-2:] == ("build", "host")
    assert path.name.startswith("libfnst_host_") and path.suffix == ".so"


@pytest.mark.parametrize("shape", [(3, 17, 23, 3), (2, 64, 96, 3)])
def test_normalize_matches_jax_and_plain(rng, shape):
    u8 = rng.integers(0, 256, shape, dtype=np.uint8)
    u8[0, 0, :3] = [[0, 0, 0], [255, 255, 255], [124, 116, 104]]  # v / 255 ~ mean
    ours = native.normalize_batch(u8)
    assert ours.dtype == np.float32 and ours.shape == shape
    np.testing.assert_array_equal(ours, jax_native.normalize_batch(u8))
    plain = native.normalize_batch_plain(u8)
    ulps = np.abs(ours.view(np.int32).astype(np.int64) - plain.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1


def test_normalize_threads_agree(rng):
    u8 = rng.integers(0, 256, (4, 128, 96, 3), dtype=np.uint8)
    np.testing.assert_array_equal(native.normalize_batch(u8, n_threads=1),
                                  native.normalize_batch(u8, n_threads=8))


def test_normalize_from_many_threads(rng):
    """Threads that load and call the library at once get the same bits."""
    u8 = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    want = native.normalize_batch(u8)
    outs = [None] * 8

    def work(i):
        outs[i] = native.normalize_batch(u8, n_threads=2)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    for o in outs:
        np.testing.assert_array_equal(o, want)


@pytest.mark.parametrize("src,dst", [((97, 61), (256, 256)), ((32, 40), (33, 80))])
def test_upscale_matches_jax(rng, src, dst):
    img = rng.integers(0, 256, (*src, 3), dtype=np.uint8)
    ours = native.resize_bilinear(img, *dst)
    np.testing.assert_array_equal(ours, jax_native.resize_bilinear(img, *dst))
    pil = native.resize_bilinear_plain(img, *dst)
    diff = np.abs(ours.astype(np.int16) - pil.astype(np.int16))
    assert ours.shape == (*dst, 3) and diff.mean() < 1.0 and np.percentile(diff, 99) <= 2


@pytest.mark.parametrize("dst", [(128, 128), (300, 100)])
def test_downscale_is_pil(rng, dst):
    img = rng.integers(0, 256, (512, 256, 3), dtype=np.uint8)
    want = np.asarray(Image.fromarray(img).resize((dst[1], dst[0]), Image.BILINEAR))
    np.testing.assert_array_equal(native.resize_bilinear(img, *dst), want)
    np.testing.assert_array_equal(jax_native.resize_bilinear(img, *dst), want)


def test_resize_identity_and_bad_input(rng):
    img = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
    np.testing.assert_array_equal(native.resize_bilinear(img, 32, 32), img)
    with pytest.raises(TypeError):
        native.normalize_batch(img.astype(np.float32)[None])
    with pytest.raises(ValueError):
        native.normalize_batch(img)
    with pytest.raises(ValueError):
        native.resize_bilinear(img, 0, 8)


def test_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "host")
    with pytest.raises(RuntimeError, match="cannot build"):
        native.build()
    assert not os.listdir(tmp_path / "host")


def test_failed_compile_raises_with_its_output(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "CXX", "false")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "host")
    with pytest.raises(RuntimeError, match="failed for .*fnst_host.cpp"):
        native.build()
