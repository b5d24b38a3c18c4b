"""FidelityFX passes — counterpart of ``vqengine_tpu/ops/ffx.py`` (the
behaviour of the vendored ffx_cas.h / ffx_fsr1.h / ffx_spd.h,
SceneRendering.cpp:2507-2788): CAS, FSR1 (EASU upscale + RCAS sharpen) and
the SPD mip pyramid (the depth hierarchy of the hi-Z reflections and the
ambient-occlusion pyramid), vectorized over [H, W, 3] images.

Rounded as the reference rounds op by op on the CPU: its Python-float
constants are f32 (weak types), its square roots correctly rounded
(shadow._sqrt), and every division by a Python number divides once
(raster.div_true; on a card PyTorch would multiply by the reciprocal).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .raster import div_true
from .shadow import _sqrt


def _f32(x: float) -> float:
    """A Python float rounded to f32, as JAX types the reference's weak
    Python-float constants."""
    return float(np.float32(x))


def _shift(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Neighbor fetch with edge clamp."""
    h, w = img.shape[0], img.shape[1]
    ys = torch.clamp(torch.arange(h, device=img.device) + dy, 0, h - 1)
    xs = torch.clamp(torch.arange(w, device=img.device) + dx, 0, w - 1)
    return img[ys][:, xs]


def _cross_neighbors(img: torch.Tensor):
    """-> (b, d, f, h): the up, left, right and down neighbors."""
    return (_shift(img, -1, 0), _shift(img, 0, -1), _shift(img, 0, 1),
            _shift(img, 1, 0))


def cas(img: torch.Tensor, sharpness: float = 0.0) -> torch.Tensor:
    """Contrast Adaptive Sharpening (ffx_cas.h behavior; the reference runs
    it disabled by default, PostProcess.h:24). img [H, W, 3], sharpness
    0..1."""
    b, d, f, h = _cross_neighbors(img)
    e = img
    a = _shift(img, -1, -1)
    c = _shift(img, -1, 1)
    g = _shift(img, 1, -1)
    i = _shift(img, 1, 1)
    mn = torch.minimum(torch.minimum(torch.minimum(d, e), torch.minimum(f, b)), h)
    mn2 = torch.minimum(mn, torch.minimum(torch.minimum(a, c), torch.minimum(g, i)))
    mn = mn + mn2
    mx = torch.maximum(torch.maximum(torch.maximum(d, e), torch.maximum(f, b)), h)
    mx2 = torch.maximum(mx, torch.maximum(torch.maximum(a, c), torch.maximum(g, i)))
    mx = mx + mx2
    rcp_mx = div_true(1.0, torch.clamp(mx, min=_f32(1e-5)))
    amp = torch.clamp(torch.minimum(mn, 2.0 - mx) * rcp_mx, 0.0, 1.0)
    amp = _sqrt(amp)
    # developer knob: peak in [-1/5, -1/8]
    peak = _f32(-1.0 / (8.0 - 3.0 * float(np.clip(sharpness, 0.0, 1.0))))
    w = amp * peak
    return (w * (b + d + f + h) + e) / (4.0 * w + 1.0)


_RCAS_LIMIT = 0.25 - 1.0 / 16.0


def rcas(img: torch.Tensor, sharpness_stops: float = 0.2) -> torch.Tensor:
    """Robust Contrast Adaptive Sharpening (FSR1's sharpening pass, ffx_fsr1.h
    FsrRcas* behavior). sharpness_stops: 0 = max sharpness, larger = softer
    (2^-stops)."""
    sharp = _f32(float(np.exp2(-sharpness_stops)))
    b, d, f, h = _cross_neighbors(img)
    e = img
    mn = torch.minimum(torch.minimum(b, d), torch.minimum(f, h))
    mn = torch.minimum(mn, e)
    mx = torch.maximum(torch.maximum(b, d), torch.maximum(f, h))
    mx = torch.maximum(mx, e)
    hit_min = mn / torch.clamp(4.0 * mx, min=_f32(1e-5))
    hit_max = (1.0 - mx) / torch.clamp(4.0 * mn - 4.0, max=_f32(-1e-5))
    lobe_rgb = torch.maximum(-hit_min, hit_max)
    lobe = torch.clamp(lobe_rgb.amax(dim=-1, keepdim=True),
                       -_RCAS_LIMIT, 0.0) * sharp
    return (lobe * (b + d + f + h) + e) / (4.0 * lobe + 1.0)


def _easu_luma(c: torch.Tensor) -> torch.Tensor:
    # EASU uses R*0.5 + G + B*0.5 as its luma proxy
    return 0.5 * c[..., 0] + c[..., 1] + 0.5 * c[..., 2]


def _easu_analysis(l_up, l_left, l_center, l_right, l_down):
    """Direction and edge length at one of the 4 nearest texels (per
    FsrEasuSet): the central differences and 1 - |second derivative| /
    range per axis."""
    dx = l_right - l_left
    dy = l_down - l_up
    eps = _f32(1e-5)
    lenx = torch.clamp(torch.abs(dx) / torch.clamp(
        torch.maximum(l_right, l_left) - torch.minimum(l_right, l_left) + eps,
        min=eps), 0.0, 1.0)
    leny = torch.clamp(torch.abs(dy) / torch.clamp(
        torch.maximum(l_down, l_up) - torch.minimum(l_down, l_up) + eps,
        min=eps), 0.0, 1.0)
    return dx, dy, lenx * lenx + leny * leny


def easu(img: torch.Tensor, out_h: int, out_w: int,
         record: dict | None = None) -> torch.Tensor:
    """Edge-adaptive spatial upsampling (ffx_fsr1.h FsrEasu* behavior):
    analyze local gradients of the source, then apply a direction/length-
    adaptive elliptical lanczos-like kernel over the 12-tap neighborhood.
    img [h, w, 3] -> [out_h, out_w, 3]. record (a dict) receives the
    integer tap origin x0i, y0i [out_h, out_w], the direction mask valid
    and the deringing bounds lo, hi."""
    h, w = img.shape[0], img.shape[1]
    dev = img.device
    # source sample position per output pixel: the reference multiplies by
    # the weak-typed ratio h / out_h, rounded to f32
    oy = (torch.arange(out_h, dtype=torch.float32, device=dev) + 0.5) \
        * _f32(h / out_h) - 0.5
    ox = (torch.arange(out_w, dtype=torch.float32, device=dev) + 0.5) \
        * _f32(w / out_w) - 0.5
    px = ox[None, :].expand(out_h, out_w)
    py = oy[:, None].expand(out_h, out_w)
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    fx = px - x0
    fy = py - y0
    x0i = x0.to(torch.int32)
    y0i = y0.to(torch.int32)
    flat = img.reshape(h * w, -1)

    def tap(dy, dx):
        yy = torch.clamp(y0i + dy, 0, h - 1)
        xx = torch.clamp(x0i + dx, 0, w - 1)
        return flat[(yy * w + xx).long()]

    # 12-tap pattern:      b c
    #                    e f g h
    #                    i j k l
    #                      n o
    tb = tap(-1, 0); tc = tap(-1, 1)
    te = tap(0, -1); tf = tap(0, 0); tg = tap(0, 1); th = tap(0, 2)
    ti = tap(1, -1); tj = tap(1, 0); tk = tap(1, 1); tl = tap(1, 2)
    tn = tap(2, 0); to = tap(2, 1)

    lb, lc = _easu_luma(tb), _easu_luma(tc)
    le, lf, lg, lh = map(_easu_luma, (te, tf, tg, th))
    li, lj, lk, ll = map(_easu_luma, (ti, tj, tk, tl))
    ln, lo = _easu_luma(tn), _easu_luma(to)

    # directional analysis at the 4 nearest texels (f, g, j, k), blended
    # bilinearly
    dfx, dfy, flen = _easu_analysis(lb, le, lf, lg, lj)
    dgx, dgy, glen = _easu_analysis(lc, lf, lg, lh, lk)
    djx, djy, jlen = _easu_analysis(lf, li, lj, lk, ln)
    dkx, dky, klen = _easu_analysis(lg, lj, lk, ll, lo)

    wf = (1 - fx) * (1 - fy)
    wg = fx * (1 - fy)
    wj = (1 - fx) * fy
    wk = fx * fy
    dirx = dfx * wf + dgx * wg + djx * wj + dkx * wk
    diry = dfy * wf + dgy * wg + djy * wj + dky * wk
    length = flen * wf + glen * wg + jlen * wj + klen * wk

    # normalize direction; degenerate -> axis-aligned (no rotation)
    dl = _sqrt(dirx * dirx + diry * diry)
    valid = dl > _f32(1e-5)
    dl9 = torch.clamp(dl, min=_f32(1e-9))
    dirx = torch.where(valid, dirx / dl9, 1.0)
    diry = torch.where(valid, diry / dl9, 0.0)
    stretch = 1.0 + 0.5 * torch.clamp(length, 0.0, 2.0)  # elongate along edge

    def kernel_weight(dy, dx):
        # rotate offset into edge frame, squash across the edge
        vx = (dx - fx) * dirx + (dy - fy) * diry
        vy = -(dx - fx) * diry + (dy - fy) * dirx
        vx = vx / stretch
        d2 = vx * vx + vy * vy
        # lanczos-like window: (25/16 (2/5 d2 - 1)^2 - 9/16) * (d2/4 - 1)^2
        d2 = torch.clamp(d2, max=4.0)
        wa = _f32(0.4) * d2 - 1.0
        wb = 0.25 * d2 - 1.0
        return (25.0 / 16.0 * wa * wa - 9.0 / 16.0) * wb * wb

    taps = [(-1, 0, tb), (-1, 1, tc), (0, -1, te), (0, 0, tf), (0, 1, tg),
            (0, 2, th), (1, -1, ti), (1, 0, tj), (1, 1, tk), (1, 2, tl),
            (2, 0, tn), (2, 1, to)]
    acc = torch.zeros((out_h, out_w, 3), dtype=torch.float32, device=dev)
    wsum = torch.zeros((out_h, out_w), dtype=torch.float32, device=dev)
    # deringing clamp bounds from the 4 nearest taps
    lo_c = torch.minimum(torch.minimum(tf, tg), torch.minimum(tj, tk))
    hi_c = torch.maximum(torch.maximum(tf, tg), torch.maximum(tj, tk))
    for dy, dx, col in taps:
        wt = kernel_weight(float(dy), float(dx))
        acc = acc + col * wt[..., None]
        wsum = wsum + wt
    out = acc / torch.clamp(wsum, min=_f32(1e-5))[..., None]
    if record is not None:
        record.update(x0i=x0i, y0i=y0i, valid=valid, lo=lo_c, hi=hi_c)
    return torch.minimum(torch.maximum(out, lo_c), hi_c)


def fsr1(img: torch.Tensor, out_h: int, out_w: int,
         sharpness_stops: float = 0.2,
         record: dict | None = None) -> torch.Tensor:
    """FSR1 = EASU upscale + RCAS sharpen (the reference's post chain when
    RenderScale < 1, SceneRendering.cpp:2507-2788; the HDR path skips
    FSR)."""
    return rcas(easu(img, out_h, out_w, record=record), sharpness_stops)


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
