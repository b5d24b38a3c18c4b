"""Screen-space reflections — counterpart of ``vqengine_tpu/ops/ssr.py``
(the reference's FFX-SSSR + DNSR stack, ScreenSpaceReflections.h:104-171,
and the ApplyReflections composite): the hi-Z DDA march over a min-depth
pyramid (dense, or on a compacted ray list), the denoiser's roughness-scaled
prefilter and its temporal resolve against a 7-channel history, and the
Fresnel-weighted composite.

The march takes integer selections at every step (the pyramid cell, its
exit boundary, the final texel), so the port rounds as the reference's CPU
run does op by op: the view-space normal as an FMA chain, the norm as
shadow.norm3, the three-term dots left to right, tan through libm's tanf
(ssao.tan_half), true division where the reference divides by a Python
number (raster.div_true), and float-to-int conversions clamped before they
truncate (_trunc_index: XLA saturates where a cast would be undefined).
A screen band (parallel/multichip.py) passes the denoiser y_offset and
full_height: it reprojects at the frame's rows into the gathered whole
history.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import ffx, sparse
from .brdf import _pow5
from .shadow import _sqrt, dot3, norm3
from .raster import div_true as _div
from .raster import scalar_on as _scalar
from .ssao import _gather, ndc_axes, tan_half, view_depth_from_ndc, view_normals

# history channel layout (the DNSR ping-pong buffers in one tensor): rgb |
# depth | temporal luminance mean | temporal luminance second moment |
# accumulated sample count
HISTORY_CHANNELS = 7
LUMA = (0.299, 0.587, 0.114)


def _reconstruct_view_pos(depth_v: torch.Tensor, tan_half_fov: float,
                          aspect) -> torch.Tensor:
    h, w = depth_v.shape
    ndc_x, ndc_y = ndc_axes(h, w, depth_v.device)
    vx = ndc_x[None, :] * tan_half_fov * aspect * depth_v
    vy = ndc_y[:, None] * tan_half_fov * depth_v
    return torch.stack([vx, vy, depth_v], dim=-1)


def _blue_noise(h: int, w: int) -> np.ndarray:
    """Tileable low-discrepancy per-pixel jitter in [0,1) — the R2 sequence
    over pixel coordinates (the counterpart of SSSR's blue-noise sampler
    texture, ScreenSpaceReflections.h:118-122)."""
    g = 1.32471795724474602596  # plastic constant
    a1, a2 = 1.0 / g, 1.0 / (g * g)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    return ((a1 * xs + a2 * ys) % 1.0).astype(np.float32)


@functools.cache
def _blue_noise_on(h: int, w: int, device: torch.device) -> torch.Tensor:
    """_blue_noise(h, w) on `device`, copied there once per size."""
    return torch.from_numpy(_blue_noise(h, w)).to(device)


def _trunc_index(x: torch.Tensor, n: int) -> torch.Tensor:
    """clip(int(x), 0, n - 1) as the reference's astype(int32) + clip:
    truncation toward zero, NaN to 0 and saturation (XLA's conversion),
    clamped before the cast."""
    return torch.clamp(torch.nan_to_num(x, nan=0.0), 0.0, float(n - 1)).to(torch.int32)


def trace_reflections(scene_color: torch.Tensor, depth: torch.Tensor,
                      normals_world: torch.Tensor, view: torch.Tensor,
                      proj_params: torch.Tensor,
                      num_steps: int = 14, refine_steps: int = 0,
                      max_distance: float = 60.0,
                      thickness: float = 0.6,
                      jitter: bool = True,
                      ray_weight: torch.Tensor | None = None,
                      ray_frac: int | None = None,
                      telemetry: dict | None = None, *,
                      tan_half_fov: float | None = None):
    """-> (reflection color [H, W, 3], confidence [H, W]).

    The hi-Z DDA march (the SSSR intersect traversal): the reflected ray is
    a screen-space segment along which 1/z is affine; each of num_steps
    lockstep iterations steps to the current pyramid cell's exit boundary,
    descends a level where the ray passes under the cell's min depth,
    ascends after a safe cell, and at level 0 solves the exact parameter
    where the ray meets the surface; rays more than `thickness` behind a
    level-0 cell skip it. jitter offsets each start by per-pixel blue
    noise. ray_frac marches only the rays that can contribute (a valid
    surface, not facing the camera, ray_weight > 1e-3 where given),
    compacted to H*W/ray_frac lanes; None marches every pixel.
    refine_steps is accepted for the reference's signature and unused.
    tan_half_fov: tan(fov_y / 2) when the caller has it (ssao.tan_half)."""
    del refine_steps
    h, w = depth.shape
    dev = depth.device
    near, far = proj_params[0], proj_params[1]
    aspect = proj_params[3]
    th = tan_half(proj_params[2]) if tan_half_fov is None else tan_half_fov

    zv = view_depth_from_ndc(depth, near, far)
    pos_v = _reconstruct_view_pos(zv, th, aspect)
    n_v = view_normals(view, normals_world)
    view_dir = pos_v / torch.clamp(norm3(pos_v), min=1e-6)[..., None]
    r = view_dir - 2.0 * dot3(view_dir, n_v)[..., None] * n_v

    # min-depth pyramid from a 2x-down base, flattened so that the
    # per-ray level fetch is one gather
    zmips = ffx.spd_mip_pyramid(ffx.reduce2(zv, "min"), num_mips=4, reduce="min")
    nlev = len(zmips)
    zoffs, off = [], 0
    for zm in zmips:
        zoffs.append(off)
        off += zm.numel()
    zflat = torch.cat([zm.reshape(-1) for zm in zmips])
    dims = [(zm.shape[0], zm.shape[1]) for zm in zmips]
    dims_t = [(_scalar(mh, dev), _scalar(mw, dev)) for mh, mw in dims]

    valid_px = depth < 1.0
    facing = torch.clamp(r[..., 2] * 4.0 + 0.5, 0.0, 1.0)
    jn_img = (_blue_noise_on(h, w, dev) if jitter
              else torch.full((h, w), 0.5, device=dev))

    def project(p):
        """view pos -> (u, v in [0, 1] y-down, 1/z)."""
        z = torch.clamp(p[..., 2], min=1e-4)
        u = (p[..., 0] / (z * th * aspect)) * 0.5 + 0.5
        v = 0.5 - (p[..., 1] / (z * th)) * 0.5
        return u, v, 1.0 / z

    def march(pos_r, r_r, valid_r, facing_r, jn_r):
        """The DDA over rays of any shape ([H, W] planes or [CAP] lists)."""
        shape = pos_r.shape[:-1]
        # the segment: the view-space endpoint clipped against z = near
        z0 = pos_r[..., 2]
        rz = r_r[..., 2]
        ahead = rz < -1e-6
        t_clip = torch.where(ahead, (near - z0) / torch.where(
            ahead, rz, torch.full_like(rz, -1.0)), torch.full_like(rz, max_distance))
        t1 = torch.clamp(t_clip, 1e-3, max_distance)
        p1 = pos_r + r_r * t1[..., None]
        u0, v0, w0 = project(pos_r)
        u1, v1, w1 = project(p1)
        du, dv, dw = u1 - u0, v1 - v0, w1 - w0

        def safe(d):
            return torch.where(torch.abs(d) > 1e-9, d, torch.full_like(d, 1e-9))

        def exit_s(o, d):
            d_safe = safe(d)
            sa = (0.0 - o) / d_safe
            sb = (1.0 - o) / d_safe
            return torch.where(torch.abs(d) > 1e-9, torch.maximum(sa, sb),
                               torch.full_like(d, 4.0))

        s_end = torch.clamp(torch.minimum(exit_s(u0, du), exit_s(v0, dv)), max=1.0)
        du_s, dv_s, dw_s = safe(du), safe(dv), safe(dw)
        stepx = (du >= 0).to(torch.float32)
        stepy = (dv >= 0).to(torch.float32)

        # start just past the ray's own pixel, phase-jittered by the noise
        base_h, base_w = dims[0]
        s_pix = 1.0 / torch.clamp(torch.maximum(torch.abs(du) * base_w,
                                                torch.abs(dv) * base_h), min=1e-6)
        s = s_pix * (0.55 + 0.9 * jn_r)

        lvl = torch.zeros(shape, dtype=torch.int32, device=dev)
        s_hit = torch.full(shape, -1.0, device=dev)
        done = s >= s_end
        eps = 1e-5
        for _ in range(num_steps):
            ux = u0 + s * du
            uy = v0 + s * dv
            # per-ray level: cell index, exit boundary and fetch index
            idx = torch.zeros(shape, dtype=torch.int32, device=dev)
            bx = torch.zeros(shape, dtype=torch.float32, device=dev)
            by = torch.zeros(shape, dtype=torch.float32, device=dev)
            for m, (mh, mw) in enumerate(dims):
                cx = torch.clamp(torch.floor(ux * mw), 0.0, mw - 1.0)
                cy = torch.clamp(torch.floor(uy * mh), 0.0, mh - 1.0)
                hitm = lvl == m
                idx = torch.where(hitm, zoffs[m] + (cy * mw + cx).to(torch.int32), idx)
                bx = torch.where(hitm, (cx + stepx) / dims_t[m][1], bx)
                by = torch.where(hitm, (cy + stepy) / dims_t[m][0], by)
            z_cell = _gather(zflat, idx)

            s_exit = torch.minimum((bx - u0) / du_s, (by - v0) / dv_s) + eps
            s_exit = torch.maximum(s_exit, s + eps)      # always progress
            s_stop = torch.minimum(s_exit, s_end)

            w_cur = w0 + s * dw
            w_stop = w0 + s_stop * dw
            z_cur = 1.0 / torch.clamp(w_cur, min=1e-6)
            z_stop = 1.0 / torch.clamp(w_stop, min=1e-6)
            z_far = torch.maximum(z_cur, z_stop)

            crossing = z_far >= z_cell
            at0 = lvl == 0
            behind = z_cur > z_cell + thickness * (1.0 + 0.04 * z_cell)
            hit_now = crossing & at0 & ~behind & ~done
            # the exact level-0 intersection: w(s*) = 1/z_cell
            s_star = (1.0 / torch.clamp(z_cell, min=1e-4) - w0) / dw_s
            s_star = torch.minimum(torch.maximum(s_star, s), s_stop)
            s_hit = torch.where(hit_now, s_star, s_hit)
            done = done | hit_now

            descend = crossing & ~at0 & ~done
            advance = (~crossing | (at0 & behind)) & ~done
            lvl = torch.where(descend, lvl - 1,
                              torch.where(advance, torch.clamp(lvl + 1, max=nlev - 1),
                                          lvl))
            s = torch.where(advance, s_stop, s)
            done = done | (s >= s_end)

        hit = s_hit > 0
        s_f = torch.where(hit, s_hit, s_end)
        u = u0 + s_f * du
        v = v0 + s_f * dv
        ty = _trunc_index(v * h, h)
        tx = _trunc_index(u * w, w)
        refl = scene_color.reshape(-1, 3)[(ty * w + tx).long()]
        # confidence: a hit, facing away from the camera, faded at the
        # screen edges
        edge = (torch.clamp(torch.minimum(u, 1 - u), 0, 0.1) * 10.0
                * torch.clamp(torch.minimum(v, 1 - v), 0, 0.1) * 10.0)
        conf = torch.where(hit & valid_r, edge, torch.zeros_like(edge)) * facing_r
        return refl, conf

    if ray_frac is None:
        return march(pos_v, r, valid_px, facing, jn_img)

    # ray compaction (SSSR's ClassifyTiles + indirect dispatch)
    active = valid_px & (facing > 0.0)
    if ray_weight is not None:
        active = active & (ray_weight > 1e-3)
    cap = -(-max(1024, (h * w) // ray_frac) // 8) * 8
    idx, count, demand = sparse.compact_indices(active, cap)
    if telemetry is not None:
        telemetry["ssr_rays"] = _div(demand.to(torch.float32), cap)
    live = (torch.arange(cap, device=dev) < count) & sparse.gather_pixels(active, idx)
    refl_c, conf_c = march(sparse.gather_pixels(pos_v, idx),
                           sparse.gather_pixels(r, idx), live,
                           sparse.gather_pixels(facing, idx),
                           sparse.gather_pixels(jn_img, idx))
    refl = sparse.scatter_pixels(torch.zeros((h, w, 3), dtype=scene_color.dtype,
                                             device=dev), idx, refl_c, live)
    conf = sparse.scatter_pixels(torch.zeros((h, w), dtype=torch.float32,
                                             device=dev), idx, conf_c, live)
    return refl, conf


def _clamped_shifts(a: torch.Tensor, axis: int):
    """(a shifted down, a shifted up) by one along axis, edge-clamped."""
    n = a.shape[axis]
    down = torch.cat([a.narrow(axis, 0, 1), a.narrow(axis, 0, n - 1)], dim=axis)
    up = torch.cat([a.narrow(axis, 1, n - 1), a.narrow(axis, n - 1, 1)], dim=axis)
    return down, up


def _local_minmax3(x: torch.Tensor):
    """3x3 neighborhood min/max of [H, W, C] via clamped-edge shifts."""
    d0, u0 = _clamped_shifts(x, 0)
    lo = torch.minimum(torch.minimum(x, d0), u0)
    hi = torch.maximum(torch.maximum(x, d0), u0)
    d1, u1 = _clamped_shifts(lo, 1)
    lo = torch.minimum(torch.minimum(lo, d1), u1)
    d1, u1 = _clamped_shifts(hi, 1)
    hi = torch.maximum(torch.maximum(hi, d1), u1)
    return lo, hi


def _local_moments3(x: torch.Tensor):
    """Separable 3x3 box mean and variance of [H, W, C] (the DNSR resolve
    pass's local statistics)."""
    three = _scalar(3.0, x.device)

    def box(a, axis):
        down, up = _clamped_shifts(a, axis)
        return (down + a + up) / three
    m1 = box(box(x, 0), 1)
    m2 = box(box(x * x, 0), 1)
    var = torch.clamp(m2 - m1 * m1, min=0.0)
    return m1, var


def _luminance(rgb: torch.Tensor) -> torch.Tensor:
    """Rec.601 luma, the three products added left to right (as XLA sums
    the reference's .sum(-1) on the CPU)."""
    return (rgb[..., 0] * LUMA[0] + rgb[..., 1] * LUMA[1]) + rgb[..., 2] * LUMA[2]


def init_history(h: int, w: int, dtype=torch.float32,
                 device: torch.device | str | None = None) -> torch.Tensor:
    """Zero history [h, w, 7] (sample count 0: nothing accumulated) at the
    SSR half resolution."""
    return torch.zeros((h, w, HISTORY_CHANNELS), dtype=dtype, device=device)


def reproject_index(motion: torch.Tensor, h: int, w: int, y_offset: int = 0,
                    full_height: int | None = None) -> torch.Tensor:
    """Flat index [H, W] of the history texel under each pixel's previous
    position: motion is the NDC delta (curr - prev), so prev px = curr -
    motion * half the frame. A band's rows sit at y_offset of a
    full_height-tall frame, whose whole history the index addresses."""
    dev = motion.device
    hf = h if full_height is None else full_height
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None] + 0.5
    if y_offset:
        ys = ys + y_offset
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :] + 0.5
    px = xs - motion[..., 0] * (w * 0.5)
    py = ys + motion[..., 1] * (hf * 0.5)
    return _trunc_index(py, hf) * w + _trunc_index(px, w)


def blur_level(roughness: torch.Tensor, hist: torch.Tensor | None,
               n_mips: int) -> torch.Tensor:
    """The prefilter's pyramid level: roughness * 4, widened where the
    tracked temporal variance is high -> int32 in [0, n_mips - 1]."""
    lvl_f = roughness * 4.0
    if hist is not None:
        tvar = torch.clamp(hist[..., 5] - hist[..., 4] * hist[..., 4], min=0.0)
        lvl_f = lvl_f + torch.clamp(tvar * 8.0, 0.0, 1.5)
    return _trunc_index(lvl_f, n_mips)


def denoise_reflections(refl: torch.Tensor, conf: torch.Tensor,
                        roughness: torch.Tensor,
                        history: torch.Tensor | None = None,
                        motion: torch.Tensor | None = None,
                        temporal_alpha: float = 0.7,
                        depth: torch.Tensor | None = None,
                        y_offset: int = 0, full_height: int | None = None):
    """DNSR-style prefilter + temporal resolve -> (denoised [H, W, 3],
    new_history [H, W, 7]): a roughness-scaled blur (mip selection, widened
    by the tracked temporal variance); the history reprojected by motion,
    clamped to the current 3x3 color bounds and to its own tracked
    luminance distribution, reset where depth or luminance disagree, and
    blended by a sample-count-ramped weight scaled by hit confidence.
    Histories with fewer than 7 channels zero-pad (sample count 0).
    A screen band (full_height given): refl, conf and the rest are the
    band's rows from frame row y_offset, history the whole frame's
    (gathered: a reprojection can land in any band); the new history is
    the band's."""
    h, w = refl.shape[:2]
    dev = refl.device
    mips = ffx.spd_mip_pyramid(refl, num_mips=4, reduce="mean")

    cur_depth = depth if depth is not None else torch.zeros((h, w), dtype=refl.dtype,
                                                            device=dev)
    hist = None
    if history is not None:
        c = history.shape[-1]
        if c < HISTORY_CHANNELS:
            history = torch.cat([history, torch.zeros(
                history.shape[:-1] + (HISTORY_CHANNELS - c,),
                dtype=history.dtype, device=history.device)], dim=-1)
        if motion is not None:
            hist = history.reshape(-1, history.shape[-1])[
                reproject_index(motion, h, w, y_offset, full_height).long()]
        elif full_height is not None:
            # the reference's dynamic_slice clamps its start; a band's
            # start is always in range
            assert 0 <= y_offset <= history.shape[0] - h, (y_offset, h)
            hist = history.narrow(0, y_offset, h)
        else:
            hist = history

    out = refl
    lvl = blur_level(roughness, hist, len(mips))
    for m in range(1, len(mips)):
        up = mips[m].repeat_interleave(1 << m, 0).repeat_interleave(1 << m, 1)
        # odd intermediate sizes floor-divide: edge-pad back up to [h, w]
        if up.shape[0] < h:
            up = up[torch.arange(h, device=dev).clamp(max=up.shape[0] - 1)]
        if up.shape[1] < w:
            up = up[:, torch.arange(w, device=dev).clamp(max=up.shape[1] - 1)]
        out = torch.where((lvl == m)[..., None], up[:h, :w], out)

    lum_cur = _luminance(out)
    if hist is not None:
        hist_rgb, hist_depth = hist[..., :3], hist[..., 3]
        hist_mu, hist_m2 = hist[..., 4], hist[..., 5]
        hist_n = hist[..., 6]
        # disocclusion: a depth mismatch resets the accumulation
        keep = torch.ones((h, w), dtype=refl.dtype, device=dev)
        if depth is not None:
            zdiff = (torch.abs(hist_depth - cur_depth)
                     / torch.clamp(torch.abs(cur_depth), min=1e-3))
            keep = torch.clamp(1.0 - zdiff * 8.0, 0.0, 1.0)
        trust = (hist_n * keep > 0.5).to(refl.dtype)
        sigma = _sqrt(torch.clamp(hist_m2 - hist_mu * hist_mu, min=0.0))
        # temporal consistency: a sample far outside the tracked mu +- 1.25
        # sigma resets the accumulation, as a disocclusion does
        excess = torch.clamp(torch.abs(lum_cur - hist_mu) - 1.25 * sigma - 0.05,
                             min=0.0)
        keep = keep * torch.where(trust > 0, torch.clamp(1.0 - excess * 4.0, 0.0, 1.0),
                                  torch.ones_like(excess))
        n = hist_n * keep
        # the history within the current 3x3 color bounds
        lo, hi = _local_minmax3(out)
        hist_rgb = torch.minimum(torch.maximum(hist_rgb, lo), hi)
        # and scaled down where brighter than its own tracked distribution
        ghost_lum = _luminance(hist_rgb)
        bound = hist_mu + 1.25 * sigma + 0.02
        scale = torch.clamp(bound / torch.clamp(ghost_lum, min=1e-6), max=1.0)
        hist_rgb = hist_rgb * torch.where(trust > 0, scale,
                                          torch.ones_like(scale))[..., None]
        # sample-count-ramped accumulation, scaled by hit confidence
        n_new = torch.clamp(n + 1.0, max=32.0)
        alpha = float(np.float32(temporal_alpha)) * (n / n_new)
        alpha = (alpha * torch.clamp(conf * 2.0, 0.25, 1.0))[..., None]
        out = alpha * hist_rgb + (1.0 - alpha) * out
        a1 = alpha[..., 0]
        lum_out = _luminance(out)
        mu_new = torch.where(trust > 0, a1 * hist_mu + (1 - a1) * lum_out, lum_out)
        m2_new = torch.where(trust > 0, a1 * hist_m2 + (1 - a1) * (lum_out * lum_out),
                             lum_out * lum_out)
    else:
        n_new = torch.ones((h, w), dtype=refl.dtype, device=dev)
        mu_new, m2_new = lum_cur, lum_cur * lum_cur
    new_history = torch.cat([out, cur_depth[..., None], mu_new[..., None],
                             m2_new[..., None], n_new[..., None]], dim=-1)
    return out, new_history


def apply_reflections(scene_color: torch.Tensor, refl: torch.Tensor,
                      conf: torch.Tensor, roughness: torch.Tensor,
                      metalness: torch.Tensor, albedo: torch.Tensor,
                      normals: torch.Tensor, view_dir: torch.Tensor) -> torch.Tensor:
    """Composite (ApplyReflections.hlsl): the denoised radiance blended in
    with a Fresnel-and-roughness weight."""
    f0 = 0.04 + (albedo - 0.04) * metalness[..., None]
    ndotv = torch.clamp(dot3(normals, view_dir), 0.0, 1.0)
    fres = f0 + (torch.maximum(1.0 - roughness[..., None], f0) - f0) \
        * _pow5(1.0 - ndotv)[..., None]
    gloss = torch.clamp(1.0 - roughness * roughness * 2.0, 0.0, 1.0)
    wgt = fres * (conf * gloss)[..., None]
    return scene_color + refl * wgt
