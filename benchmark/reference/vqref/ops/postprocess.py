"""Post-process chain — counterpart of ``vqengine_tpu/ops/postprocess.py``
(SceneRendering.cpp:2507-2788): the tonemapper (Tonemapper.hlsl:110-151:
Reinhard + sRGB, the ST.2084 HDR10 curve, linear) and the separable
gaussian blur (GaussianBlur.hlsl). CAS and FSR1 live in ops/ffx.py.
"""
from __future__ import annotations

import numpy as np
import torch

from . import colorspace as cs


def tonemap_reinhard(color: torch.Tensor) -> torch.Tensor:
    """Tonemapper.hlsl:24-27: c / (c + 1)."""
    return color / (color + 1.0)


def tonemap(color: torch.Tensor,
            output_display_curve: int = cs.DISPLAY_CURVE_SRGB,
            content_color_space: int = cs.COLOR_SPACE_REC709,
            display_reference_brightness: float = 200.0,
            apply_gamma: bool = True) -> torch.Tensor:
    """The tonemapper CS (Tonemapper.hlsl:110-151).

    - sRGB: Reinhard, then the sRGB curve if apply_gamma.
    - ST.2084: Rec709 -> Rec2020 unless the content is Rec2020 already,
      scaled by brightness / ST2084_MAX (rounded to f32, as the
      reference's weak-typed Python float), then the PQ curve. No
      tonemap operator (HDR10 output).
    - linear: passthrough.
    """
    if output_display_curve == cs.DISPLAY_CURVE_SRGB:
        out = tonemap_reinhard(color)
        return cs.linear_to_srgb_fast(out) if apply_gamma else out
    if output_display_curve == cs.DISPLAY_CURVE_ST2084:
        out = color
        if content_color_space == cs.COLOR_SPACE_REC709:
            out = cs.rec709_to_rec2020(out)
        scale = float(np.float32(display_reference_brightness / cs.ST2084_MAX))
        return cs.linear_to_st2084(out * scale)
    return color


# ---------------------------------------------------------------------------
# separable gaussian blur (GaussianBlur.hlsl behavior: X pass then Y pass)
# ---------------------------------------------------------------------------

def _gaussian_kernel(radius: int, sigma: float) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: torch.Tensor, radius: int = 4,
                  sigma: float = 2.0) -> torch.Tensor:
    """img [H, W, C] -> blurred [H, W, C]; separable X then Y with edge
    clamp. The taps add in the reference's order: 0 + w0 x0 + w1 x1 ..."""
    weights = _gaussian_kernel(radius, sigma)

    def blur_axis(x: torch.Tensor, axis: int) -> torch.Tensor:
        n = x.shape[axis]
        out = torch.zeros_like(x)
        for i, w in enumerate(weights):
            idx = torch.clamp(torch.arange(n, device=x.device) + (i - radius),
                              0, n - 1)
            out = out + float(w) * x.index_select(axis, idx)
        return out

    return blur_axis(blur_axis(img, 1), 0)
