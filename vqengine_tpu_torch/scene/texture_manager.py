"""Procedural textures of the texture manager — the part of
``vqengine_tpu/scene/texture_manager.py`` that the typed scenes use
(``scenes.py``: ``noise_texture``). The manager itself, its mip chains and
its device arrays are not ported yet (textures are a later slice).
"""
from __future__ import annotations

import numpy as np


def _to_rgba_f32(img: np.ndarray) -> np.ndarray:
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    img = img.astype(np.float32)
    if img.ndim == 2:
        img = img[:, :, None]
    c = img.shape[2]
    if c == 1:
        img = np.repeat(img, 3, axis=2)
        c = 3
    if c == 2:
        img = np.concatenate([img[:, :, :1].repeat(3, 2), img[:, :, 1:2]], 2)
        c = 4
    if c == 3:
        img = np.concatenate([img, np.ones_like(img[:, :, :1])], axis=2)
    return img[:, :, :4]


def noise_texture(size: int = 128, base: float = 0.5, amp: float = 0.35,
                  octaves: int = 4, seed: int = 9) -> np.ndarray:
    """Tileable value-noise grayscale (roughness/height maps)."""
    rng = np.random.default_rng(seed)
    acc = np.zeros((size, size), np.float32)
    for o in range(octaves):
        n = 4 << o
        g = rng.random((n, n)).astype(np.float32)
        g = np.concatenate([g, g[:, :1]], axis=1)
        g = np.concatenate([g, g[:1, :]], axis=0)
        t = np.linspace(0, n, size, endpoint=False)
        i = np.floor(t).astype(int)
        f = (t - i)[None, :]
        fv = (t - i)[:, None]
        a = g[np.ix_(i, i)] * (1 - f) + g[np.ix_(i, i + 1)] * f
        b = g[np.ix_(i + 1, i)] * (1 - f) + g[np.ix_(i + 1, i + 1)] * f
        acc += (a * (1 - fv) + b * fv) * (0.5 ** o)
    acc /= sum(0.5 ** o for o in range(octaves))
    return _to_rgba_f32(np.clip(base + amp * (acc * 2 - 1), 0, 1)[..., None])
