"""SSIM, the output-parity metric for trained-weights checks.

Standard Wang et al. 2004 SSIM: 11x11 Gaussian window (sigma 1.5),
K1=0.01, K2=0.03, computed per channel on [0, 1] images and averaged.
Pure NumPy so parity checks never need a device.
"""

from __future__ import annotations

import numpy as np


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    ax = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-0.5 * (ax / sigma) ** 2)
    k = np.outer(g, g)
    return k / k.sum()


def _filter2d_valid(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """VALID 2-D correlation via stride tricks (img HW, kernel kk)."""
    k = kernel.shape[0]
    windows = np.lib.stride_tricks.sliding_window_view(img, (k, k))
    return np.einsum("ijkl,kl->ij", windows, kernel, optimize=True)


def ssim(a: np.ndarray, b: np.ndarray, *, data_range: float = 1.0) -> float:
    """Mean SSIM between two (H, W), (H, W, C) or (N, H, W, C) images."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    if a.ndim == 4:
        return float(np.mean([ssim(x, y, data_range=data_range) for x, y in zip(a, b)]))
    if a.ndim == 3:
        return float(
            np.mean([ssim(a[..., c], b[..., c], data_range=data_range)
                     for c in range(a.shape[-1])])
        )
    kernel = _gaussian_kernel()
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_a = _filter2d_valid(a, kernel)
    mu_b = _filter2d_valid(b, kernel)
    mu_aa = mu_a * mu_a
    mu_bb = mu_b * mu_b
    mu_ab = mu_a * mu_b
    sigma_aa = _filter2d_valid(a * a, kernel) - mu_aa
    sigma_bb = _filter2d_valid(b * b, kernel) - mu_bb
    sigma_ab = _filter2d_valid(a * b, kernel) - mu_ab
    num = (2 * mu_ab + c1) * (2 * sigma_ab + c2)
    den = (mu_aa + mu_bb + c1) * (sigma_aa + sigma_bb + c2)
    return float(np.mean(num / den))


def ssim_files(path_a: str, path_b: str) -> float:
    """SSIM between two image files, the second resized (PIL bilinear) to
    the first's size if they differ."""
    from fast_neural_style_transfer_tpu_torch.utils.image_io import decode_image, resize_image

    a = decode_image(path_a)
    b = decode_image(path_b)
    if a.shape != b.shape:
        b = resize_image(b, a.shape[:2])
    return ssim(a / 255.0, b / 255.0)
