"""Color-space curves — counterpart of ``vqengine_tpu/ops/colorspace.py``
(HDR.hlsl). Ported: what the tonemapper's sRGB and linear outputs use and
the pow-2.2 texture decode; the exact sRGB pair and the ST.2084 / Rec2020
path come with the slices that use them.
"""
from __future__ import annotations

import torch

DISPLAY_CURVE_SRGB = 0
DISPLAY_CURVE_ST2084 = 1
DISPLAY_CURVE_LINEAR = 2


def linear_to_srgb_fast(c: torch.Tensor) -> torch.Tensor:
    """sRGB OETF with x^(1/2.4) replaced by the reference's 2-sqrt
    polynomial (max |error| 7e-4 on [0.0031308, 1])."""
    x = torch.clamp(c, 0.0, 1.0)
    u2 = torch.sqrt(x)
    u4 = torch.sqrt(u2)
    p = 0.11983648 * u4 + 1.23117423 * u2 - 0.49498088 * u2 * u4 + 0.14414322 * x
    return torch.where(x < 0.0031308, 12.92 * x, 1.055 * p - 0.055)


_F32_2_2 = 2.200000047683716      # the reference's exponent, 2.2 in f32


def srgb_to_linear_fast(c: torch.Tensor) -> torch.Tensor:
    """ShadingMath.hlsl:65, the pow-2.2 approximation the forward-lighting
    shader uses for the albedo and emissive decode. The reference's
    jnp.power is libm's powf; the power is taken in f64 here (1 f32 ulp
    off on 0.06% of inputs in [0, 1], where torch's f32 pow is off on
    1.8%)."""
    return torch.pow(torch.clamp(c, min=0.0).double(), _F32_2_2).float()
