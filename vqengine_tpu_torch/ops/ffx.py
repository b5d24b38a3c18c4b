"""FidelityFX passes — counterpart of ``vqengine_tpu/ops/ffx.py``. So far
only the SPD mip pyramid (ffx_spd.h: the whole mip chain; the depth
hierarchy of the hi-Z reflections and the ambient-occlusion pyramid) is
ported; CAS, RCAS, EASU and FSR1 come with the post tail.
"""
from __future__ import annotations

import math

import torch


def reduce2(x: torch.Tensor, reduce: str = "mean") -> torch.Tensor:
    """2x2 reduction of [H, W, ...] (odd sizes truncate). A 2x2 block
    (a b / c d) averages as XLA reduces the reference's reshape mean over
    axes (1, 3) on the CPU: ((a + b) + (c + d)) / 4 where an output row
    (W/2 times the trailing size) holds a power of two of elements, else
    (((a + b) + c) + d) / 4 (measured over W/2 of 1-2048 and 1-8
    channels)."""
    h = x.shape[0] // 2 * 2
    w = x.shape[1] // 2 * 2
    a, b = x[0:h:2, 0:w:2], x[0:h:2, 1:w:2]
    c, d = x[1:h:2, 0:w:2], x[1:h:2, 1:w:2]
    if reduce == "min":
        return torch.minimum(torch.minimum(a, b), torch.minimum(c, d))
    if reduce == "max":
        return torch.maximum(torch.maximum(a, b), torch.maximum(c, d))
    if reduce != "mean":
        raise ValueError(f"reduce2: unknown reduce {reduce!r}")
    row = (w // 2) * math.prod(x.shape[2:])
    if row & (row - 1) == 0:
        return ((a + b) + (c + d)) / 4.0
    return (((a + b) + c) + d) / 4.0


def spd_mip_pyramid(img: torch.Tensor, num_mips: int | None = None,
                    reduce: str = "mean") -> list[torch.Tensor]:
    """-> [img, mip1, mip2, ...] of [H, W] or [H, W, C]; reduce in {mean,
    min, max}. Odd dimensions are truncated like GPU mip chains."""
    mips = [img]
    cur = img
    while ((num_mips is None or len(mips) < num_mips)
           and min(cur.shape[:2]) >= 2):
        cur = reduce2(cur, reduce)
        mips.append(cur)
    return mips
