"""The benchmark's own count of the least work of the raster kernels, from
the frame's shapes and the scene's triangle count alone, and the card's
published peaks.

A kernel's roofline share is the least time the card could take for its
launches (the larger of bytes over the peak bandwidth and operations over
the peak f32 rate) over the time its launches took in the trace. Inputs
are counted once and outputs once; nothing is counted from the program's
own intermediate data (bins, pairs, record streams), so the share reads
the same work whatever implements the kernel.
"""
from __future__ import annotations

# NVIDIA H100 SXM5 data sheet, dense, at the full 700 W power limit
PEAK_BYTES_PER_S = 3.35e12       # HBM3
PEAK_F32_FLOP_PER_S = 67e12      # f32 outside the tensor cores

# a triangle as a rasterizer must read it: three clip-space positions
# (xyzw f32) ...
TRI_CLIP_BYTES = 3 * 16
# ... and, for a G-buffer, per vertex its normal, tangent (3 f32 each) and
# uv (2 f32), and the triangle's material, object and item ids (3 i32)
TRI_GBUF_BYTES = TRI_CLIP_BYTES + 3 * (3 + 3 + 2) * 4 + 3 * 4
# K1-MSAA writes per pixel: depth f32, triangle id i32, the 16-channel f32
# G-buffer and 4 coverage samples f32
GBUF_MSAA_PIXEL_BYTES = 4 + 4 + 16 * 4 + 4 * 4
# K2 writes per texel: depth f32, triangle id i32
VIS_TEXEL_BYTES = 4 + 4
# operations per pixel against the one triangle that covers it: four
# samples' three edge functions and depth plane, and the attribute
# interpolation (K1-MSAA); the centre's edges and depth (K2)
OPS_GBUF_MSAA = 52
OPS_VIS = 36


def bound_s(bytes_: float, ops: float) -> float:
    return max(bytes_ / PEAK_BYTES_PER_S, ops / PEAK_F32_FLOP_PER_S)


def k1_msaa_bound_s(width: int, height: int, triangles: int) -> float:
    """One K1-MSAA launch: the frame's G-buffer at width x height."""
    px = width * height
    return bound_s(triangles * TRI_GBUF_BYTES + px * GBUF_MSAA_PIXEL_BYTES,
                   px * OPS_GBUF_MSAA)


def k2_bound_s(size: int, triangles: int) -> float:
    """One K2 launch: a size x size depth view of every triangle."""
    px = size * size
    return bound_s(triangles * TRI_CLIP_BYTES + px * VIS_TEXEL_BYTES,
                   px * OPS_VIS)


def share_percent(bound: float, measured_s: float) -> float | None:
    """The roofline share in percent; None where nothing was measured."""
    if measured_s <= 0.0:
        return None
    return 100.0 * bound / measured_s
