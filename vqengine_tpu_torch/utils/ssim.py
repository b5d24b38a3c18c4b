"""SSIM — the image-fidelity metric for golden-frame regression tests
(BASELINE.md: SSIM >= 0.98 vs reference frames)."""
from __future__ import annotations

import numpy as np


def _gaussian_kernel(radius: int = 5, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _filter2d(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Separable gaussian filter with edge clamp, channels last."""
    def conv_axis(a, axis):
        pad = len(k) // 2
        padded = np.take(a, np.clip(np.arange(-pad, a.shape[axis] + pad),
                                    0, a.shape[axis] - 1), axis=axis)
        out = np.zeros_like(a)
        for i, w in enumerate(k):
            sl = [slice(None)] * a.ndim
            sl[axis] = slice(i, i + a.shape[axis])
            out = out + w * padded[tuple(sl)]
        return out
    return conv_axis(conv_axis(img, 0), 1)


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 1.0) -> float:
    """Mean SSIM over the image (gaussian-windowed, standard constants)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 3:
        return float(np.mean([ssim(a[..., c], b[..., c], data_range)
                              for c in range(a.shape[2])]))
    k = _gaussian_kernel()
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_a = _filter2d(a, k)
    mu_b = _filter2d(b, k)
    var_a = _filter2d(a * a, k) - mu_a * mu_a
    var_b = _filter2d(b * b, k) - mu_b * mu_b
    cov = _filter2d(a * b, k) - mu_a * mu_b
    num = (2 * mu_a * mu_b + c1) * (2 * cov + c2)
    den = (mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2)
    return float(np.mean(num / den))
