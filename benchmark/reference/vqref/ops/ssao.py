"""Screen-space ambient occlusion — counterpart of
``vqengine_tpu/ops/ssao.py`` (the reference's FFX-CACAO pass,
AmbientOcclusionPass.{h,cpp}, ffx_cacao_impl.cpp): view-space depth and
a mean-reduced depth pyramid, the spiral-tap occlusion integral (dense,
deinterleaved in four phase layers, or with the importance-ranked adaptive
refinement on ops/sparse.py), the depth-aware blur, and the depth-guided
bilateral upsample.

The reference's row-fetch gather (gather_scalar_rows4, a TPU layout trick
that leaves values unchanged) is a plain gather here. A screen band
(parallel/multichip.py) passes y_offset and full_height: the view-space
reconstruction, the aspect and the tap radius take the frame's geometry.

Rounding follows the reference's CPU run op by op, so that every integer
selection (the tap's pyramid level and texel) lands where the reference's
does: the view-space normal is an FMA chain (XLA's "ij,hwj->hwi" with three
terms), norms and square roots as shadow.norm3 and shadow._sqrt, the tap's
level from f32 distance thresholds (MIP_DIST_THRESHOLD_BITS) instead of a
log2 that rounds otherwise than XLA's, tan through libm's tanf (tan_half),
the blur's and the upsample's exp as XLA's (texture.exp_xla).
A division by a Python number divides by a device scalar (raster.div_true):
on a card PyTorch turns x / c into x * (1 / c), which rounds otherwise.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import _backend, ffx, sparse
from .raster import _fma
from .raster import div_true as _div
from .raster import scalar_on as _scalar
from .shadow import _sqrt
from .texture import exp_xla

# CACAO's quality ladder (the reference's PRESETS, ssao.py:124): base spiral
# taps, adaptive refinement taps, deinterleaved generation
PRESETS = {
    "lowest": (4, 0, False),
    "low": (6, 0, False),
    "medium": (12, 0, False),
    "high": (12, 8, False),
    "adaptive": (12, 12, True),
}

# The tap's pyramid level is int(clip(log2(max(dist, 1)) - 3, 0, levels - 1))
# in the reference (ssao.py:91-93). Its level is at least k exactly where
# the f32 distance is at least the k-th of these f32 values (bit patterns),
# found by bisection against the reference's CPU log2, which rounds
# otherwise than torch's (tests/test_torch_ssao.py finds them again and
# checks the level around each).
MIP_DIST_THRESHOLD_BITS = (0x417FFFFF, 0x41FFFFFF, 0x427FFFFD)
MIP_DIST_THRESHOLDS = tuple(float(np.array(b, np.uint32).view(np.float32))
                            for b in MIP_DIST_THRESHOLD_BITS)


@functools.cache
def _tanf(x: float) -> float:
    return float(np.float32(_backend.libm_f32("tanf")(x)))


def tan_half(fov_y) -> float:
    """tan(fov_y * 0.5) of the f32 vertical field of view, as the
    reference's jnp.tan rounds it on the CPU (XLA calls libm's tanf; torch's
    tan rounds otherwise on about 4% of angles). Computed on the host: a
    card-resident fov_y costs one device sync."""
    half = np.float32(np.float32(float(fov_y)) * np.float32(0.5))
    return _tanf(float(half))


def view_depth_from_ndc(depth: torch.Tensor, near, far) -> torch.Tensor:
    """z_ndc [H, W] in [0, 1] (D3D) -> view-space depth; background -> far."""
    denom = torch.clamp(far - depth * (far - near), min=1e-6)
    z = _div(near * far, denom)
    far_t = far if isinstance(far, torch.Tensor) else _scalar(far, depth.device)
    return torch.where(depth >= 1.0, far_t, z)


def _spiral_taps(num: int, seed: int = 7) -> np.ndarray:
    """Golden-angle spiral tap pattern [num, 2] in the unit disk."""
    i = np.arange(num, dtype=np.float32) + 0.5
    r = np.sqrt(i / num)
    a = i * 2.399963229728653 + seed
    return np.stack([r * np.cos(a), r * np.sin(a)], -1).astype(np.float32)


def _gather(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """flat [N] at idx (any shape): one tap's pyramid fetch."""
    return flat[idx.long()]


def tap_level(dist_px: torch.Tensor, n_mips: int) -> torch.Tensor:
    """The reference's int(clip(log2(max(dist_px, 1)) - 3, 0, n_mips - 1))
    by the f32 thresholds MIP_DIST_THRESHOLDS -> int32."""
    lvl = torch.zeros(dist_px.shape, dtype=torch.int32, device=dist_px.device)
    for t in MIP_DIST_THRESHOLDS[:n_mips - 1]:
        lvl = lvl + (dist_px >= t).to(torch.int32)
    return lvl


def _occlusion_sum(taps: np.ndarray, px, py, pos_v, nrm_v, radius_px_y,
                   zflat, zoffs, zshapes, w, h, geom) -> torch.Tensor:
    """Sum the spiral taps' occlusion for pixels of any shape: dense [H, W]
    planes, compacted [CAP] lists, or [4, H/2, W/2] phase stacks with taps
    [4, T, 2] (one pattern per phase). geom = (tan_half, aspect, y_offset,
    full_height, radius_world): a band's rows sit at y_offset of a
    full_height-tall frame."""
    tan_half, aspect, y_offset, full_height, radius_world = geom
    dev = px.device
    occlusion = torch.zeros(px.shape, dtype=torch.float32, device=dev)
    n_mips = len(zshapes)
    per_phase = taps.ndim == 3
    tt = torch.from_numpy(taps).to(dev) if per_phase else None
    w_t, h_t = _scalar(w, dev), _scalar(full_height, dev)
    r_t = _scalar(radius_world, dev)
    px_, py_, pz_ = pos_v.unbind(-1)
    nx, ny, nz = nrm_v.unbind(-1)
    for t in range(taps.shape[-2]):
        if per_phase:
            shape = (-1,) + (1,) * (px.ndim - 1)
            tx_t, ty_t = tt[:, t, 0].reshape(shape), tt[:, t, 1].reshape(shape)
        else:
            tx_t, ty_t = float(taps[t, 0]), float(taps[t, 1])
        dx = tx_t * radius_px_y
        dy = ty_t * radius_px_y
        sx = torch.clamp(px + dx, 0.5, w - 0.5)
        sy = torch.clamp(py + dy, 0.5, h - 0.5)
        # pyramid level by tap distance in pixels
        mip = tap_level(_sqrt(dx * dx + dy * dy), n_mips)
        idx = torch.zeros(px.shape, dtype=torch.int32, device=dev)
        for m, (mh, mw) in enumerate(zshapes):
            # level m sits at input scale 2^(m+1) (a 2x-down base)
            ty = torch.clamp((sy / float(1 << (m + 1))).to(torch.int32), 0, mh - 1)
            tx = torch.clamp((sx / float(1 << (m + 1))).to(torch.int32), 0, mw - 1)
            idx = torch.where(mip == m, zoffs[m] + ty * mw + tx, idx)
        z_tap = _gather(zflat, idx)
        # view-space sample position
        s_ndc_x = (sx / w_t) * 2.0 - 1.0
        s_ndc_y = 1.0 - ((sy + float(y_offset) if y_offset else sy) / h_t) * 2.0
        ddx = s_ndc_x * tan_half * aspect * z_tap - px_
        ddy = s_ndc_y * tan_half * z_tap - py_
        ddz = z_tap - pz_
        dist = _sqrt(_fma(ddz, ddz, _fma(ddy, ddy, ddx * ddx)))
        inv = torch.clamp(dist, min=1e-6)
        # horizon-style occlusion: cosine-weighted, range-attenuated
        cos_h = ((ddx / inv) * nx + (ddy / inv) * ny) + (ddz / inv) * nz
        falloff = torch.clamp(1.0 - dist / r_t, 0.0, 1.0)
        occlusion = occlusion + torch.clamp(cos_h - 0.1, 0.0, 1.0) * falloff
    return occlusion


def view_normals(view: torch.Tensor, normals: torch.Tensor) -> torch.Tensor:
    """World normals [..., 3] -> view space by view[:3, :3]: each row an FMA
    chain over j = 0, 1, 2, as XLA rounds the reference's einsum
    "ij,hwj->hwi" on the CPU."""
    rows = []
    for i in range(3):
        acc = _fma(view[i, 1], normals[..., 1], view[i, 0] * normals[..., 0])
        rows.append(_fma(view[i, 2], normals[..., 2], acc))
    return torch.stack(rows, dim=-1)


def importance_map(ao: torch.Tensor, block: int = 4) -> torch.Tensor:
    """CACAO's importance metric: per-block AO contrast (max - min over
    block x block), one 3x3 box smooth across the block seams, broadcast
    back to per-pixel (edge-padded where the frame is not whole blocks)."""
    h, w = ao.shape
    hb, wb = h // block * block, w // block * block
    a = ao[:hb, :wb].reshape(hb // block, block, wb // block, block)
    imp = a.amax(dim=(1, 3)) - a.amin(dim=(1, 3))
    k = float(np.float32(1.0) / np.float32(9.0))
    rows = torch.arange(-1, hb // block + 1, device=ao.device).clamp(0, hb // block - 1)
    cols = torch.arange(-1, wb // block + 1, device=ao.device).clamp(0, wb // block - 1)
    imp = imp[rows][:, cols]                         # edge pad 1
    sm = torch.zeros((hb // block, wb // block), dtype=torch.float32,
                     device=ao.device)
    for oy in range(3):
        for ox in range(3):
            sm = sm + imp[oy:oy + hb // block, ox:ox + wb // block] * k
    full = sm.repeat_interleave(block, 0).repeat_interleave(block, 1)
    if (hb, wb) != (h, w):
        full = full[torch.arange(h, device=ao.device).clamp(max=hb - 1)]
        full = full[:, torch.arange(w, device=ao.device).clamp(max=wb - 1)]
    return full


def _pixel_centers(h: int, w: int, dev):
    """(px, py) [H, W]: x + 0.5 and y + 0.5."""
    px = (torch.arange(w, dtype=torch.float32, device=dev)[None, :] + 0.5).expand(h, w)
    py = (torch.arange(h, dtype=torch.float32, device=dev)[:, None] + 0.5).expand(h, w)
    return px, py


def ndc_axes(h: int, w: int, dev, y_offset: int = 0,
             full_height: int | None = None):
    """(ndc_x [W], ndc_y [H]) of the pixel centers, divided as the reference
    divides them (true division); a band's rows start at y_offset of a
    full_height-tall frame."""
    ndc_x = _div(torch.arange(w, dtype=torch.float32, device=dev) + 0.5, w) * 2.0 - 1.0
    rows = torch.arange(h, dtype=torch.float32, device=dev)
    if y_offset:
        rows = rows + y_offset
    ndc_y = 1.0 - _div(rows + 0.5, h if full_height is None else full_height) * 2.0
    return ndc_x, ndc_y


def ssao(depth: torch.Tensor, normals: torch.Tensor, view_proj_info: dict,
         radius_world: float = 1.2, num_taps: int = 12,
         intensity: float = 1.0, power: float = 1.5,
         skip_blur: bool = False,
         adaptive_taps: int = 0,
         importance_threshold: float = 0.04,
         adaptive_frac: int = 4,
         deinterleave: bool = False,
         telemetry: dict | None = None, *,
         tan_half_fov: float | None = None, y_offset: int = 0,
         full_height: int | None = None) -> torch.Tensor:
    """-> AO [H, W] in [0, 1] (1 = unoccluded).

    depth: z_ndc [H, W]; normals: world normals [H, W, 3]; view_proj_info:
    dict(near, far, fov_y, view [4, 4]). adaptive_taps > 0 adds that many
    spiral taps (an independent seed) on the pixels whose base-pass AO
    contrast ranks highest (at most one in adaptive_frac, compacted);
    deinterleave generates four phase-offset quarter-resolution layers
    with their own spirals. tan_half_fov: tan(fov_y / 2) when the caller
    has it (tan_half), which spares a device sync. A screen band: depth is
    the slab whose first row is row y_offset (negative for a halo above the
    frame) of a full_height-tall frame; the deinterleave needs even band
    heights and offsets, so that a row's parity is its frame row's."""
    h, w = depth.shape
    fh = h if full_height is None else full_height
    dev = depth.device
    near, far = view_proj_info["near"], view_proj_info["far"]
    view = view_proj_info["view"]
    th = tan_half(view_proj_info["fov_y"]) if tan_half_fov is None else tan_half_fov

    zv = view_depth_from_ndc(depth, near, far)
    aspect = w / fh
    ndc_x, ndc_y = ndc_axes(h, w, dev, y_offset, fh)
    vx = ndc_x[None, :] * th * aspect * zv
    vy = ndc_y[:, None] * th * zv
    pos_v = torch.stack([vx, vy, zv], dim=-1)
    nrm_v = view_normals(view, normals)

    # screen-space tap radius: the projected world radius, clamped
    radius_px_y = torch.clamp(_div(radius_world, zv * th * 2.0) * fh, 2.0, 96.0)

    # the depth pyramid (CACAO's depth prepare) on a 2x-down base, flattened
    # so that each tap is one gather at a level-selected index
    zbase = ffx.reduce2(zv)
    zmips = ffx.spd_mip_pyramid(zbase[..., None], num_mips=4, reduce="mean")
    zoffs, zshapes, off = [], [], 0
    for zm in zmips:
        zoffs.append(off)
        zshapes.append((zm.shape[0], zm.shape[1]))
        off += zm.shape[0] * zm.shape[1]
    zflat = torch.cat([zm.reshape(-1) for zm in zmips])

    geom = (th, aspect, y_offset, fh, radius_world)
    px, py = _pixel_centers(h, w, dev)

    if deinterleave and h >= 2 and w >= 2:
        # four phase-offset quarter-resolution layers, each with its own
        # spiral; the blur recombines neighbors
        h2, w2 = h // 2, w // 2

        def d4(img):
            x = img[: h2 * 2, : w2 * 2]
            return torch.stack([x[0::2, 0::2], x[0::2, 1::2],
                                x[1::2, 0::2], x[1::2, 1::2]])

        taps4 = np.stack([_spiral_taps(num_taps, seed=7 + 13 * p)
                          for p in range(4)])
        occ4 = _occlusion_sum(taps4, d4(px), d4(py), d4(pos_v), d4(nrm_v),
                              d4(radius_px_y), zflat, zoffs, zshapes, w, h,
                              geom)
        inter = torch.stack([torch.stack([occ4[0], occ4[1]], -1),
                             torch.stack([occ4[2], occ4[3]], -1)], 1)
        occlusion = inter.reshape(h2 * 2, w2 * 2)
        if (h2 * 2, w2 * 2) != (h, w):
            occlusion = occlusion[torch.arange(h, device=dev).clamp(max=h2 * 2 - 1)]
            occlusion = occlusion[:, torch.arange(w, device=dev).clamp(max=w2 * 2 - 1)]
    else:
        occlusion = _occlusion_sum(_spiral_taps(num_taps), px, py, pos_v,
                                   nrm_v, radius_px_y, zflat, zoffs, zshapes,
                                   w, h, geom)
    n_taps = torch.full((h, w), float(num_taps), dtype=torch.float32, device=dev)

    if adaptive_taps > 0:
        ao0 = 1.0 - torch.clamp(occlusion / n_taps * 2.0 * intensity, 0.0, 1.0)
        imp = importance_map(ao0)
        cap = -(-max(512, (h * w) // adaptive_frac) // 8) * 8
        thrs = tuple(importance_threshold * f
                     for f in (1.0, 1.5, 2.2, 3.2, 4.7, 7.0, 10.0, 15.0))
        thr, _ = sparse.adaptive_threshold(imp, thrs, cap)
        important = imp > thr
        idx, count, demand = sparse.compact_indices(important, cap)
        if telemetry is not None:
            telemetry["ssao_refine"] = _div(demand.to(torch.float32), cap)
            telemetry["ssao_refine_demand"] = _div(sparse.block_count(
                imp > importance_threshold, 1).to(torch.float32), cap)
        live = (torch.arange(cap, device=dev) < count) & sparse.gather_pixels(
            important, idx)

        def g(v):
            return sparse.gather_pixels(v, idx)

        # the refinement spiral has its own seed, so that the base pass
        # stays the non-adaptive config's bit for bit
        occ_c = _occlusion_sum(_spiral_taps(adaptive_taps, seed=31), g(px),
                               g(py), g(pos_v), g(nrm_v), g(radius_px_y),
                               zflat, zoffs, zshapes, w, h, geom)
        occlusion = sparse.scatter_pixels(occlusion, idx, g(occlusion) + occ_c,
                                          live)
        n_taps = sparse.scatter_pixels(
            n_taps, idx, torch.full((cap,), float(num_taps + adaptive_taps),
                                    device=dev), live)

    ao = 1.0 - torch.clamp(occlusion / n_taps * 2.0 * intensity, 0.0, 1.0)
    if power == 1.5:
        ao = ao * _sqrt(ao)
    else:
        ao = torch.pow(torch.clamp(ao, 0.0, 1.0), power)
    if skip_blur:
        return ao
    return _bilateral_blur(ao, zv)


def _bilateral_blur(ao: torch.Tensor, zv: torch.Tensor, radius: int = 2,
                    depth_sigma: float = 0.1) -> torch.Tensor:
    """Depth-aware separable blur (CACAO's edge-aware blur), along x then
    y, edge-clamped."""
    def blur_axis(a, z, axis):
        acc = torch.zeros_like(a)
        wacc = torch.zeros_like(a)
        n = a.shape[axis]
        denom = depth_sigma * torch.clamp(z, min=1e-3)
        offs = range(-radius, radius + 1)
        idx = [(torch.arange(n, device=a.device) + o).clamp(0, n - 1) for o in offs]
        # every tap's depth weight in one exp_xla call (elementwise: the
        # same values, a fifth of the launches)
        wzs = exp_xla(torch.stack([-torch.abs(z.index_select(axis, i) - z) / denom
                                   for i in idx]))
        for o, i, wz in zip(offs, idx, wzs):
            a_o = a.index_select(axis, i)
            wg = float(np.exp(-0.5 * (o / max(radius, 1)) ** 2))
            acc = acc + a_o * wz * wg
            wacc = wacc + wz * wg
        return acc / torch.clamp(wacc, min=1e-6)
    return blur_axis(blur_axis(ao, zv, 1), zv, 0)


def _shift(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """img [h, w] read at (y + dy, x + dx), edge-clamped (the reference's
    edge pad and slice)."""
    h, w = img.shape
    rows = (torch.arange(h, device=img.device) + dy).clamp(0, h - 1)
    cols = (torch.arange(w, device=img.device) + dx).clamp(0, w - 1)
    return img[rows][:, cols]


def upsample_bilateral(ao: torch.Tensor, z_coarse: torch.Tensor,
                       z_fine: torch.Tensor,
                       depth_sigma: float = 0.05) -> torch.Tensor:
    """Depth-guided 2x upsample (CACAO's edge-aware Apply): each fine pixel
    blends its 4 nearest coarse samples with bilinear weights modulated by
    depth similarity. ao, z_coarse [h, w]; z_fine [H, W] with H <= 2h,
    W <= 2w."""
    h, w = ao.shape
    fh, fw = z_fine.shape
    if fh > 2 * h or fw > 2 * w:
        # the reference's edge pad to (2h, 2w) refuses a negative width
        raise ValueError(f"upsample_bilateral: fine {fh}x{fw} exceeds twice "
                         f"the coarse {h}x{w}")
    dev = ao.device
    zf = z_fine[torch.arange(2 * h, device=dev).clamp(max=fh - 1)]
    zf = zf[:, torch.arange(2 * w, device=dev).clamp(max=fw - 1)]
    # the 16 (phase, tap) depth weights in one exp_xla call (elementwise:
    # the same values, a sixteenth of the launches)
    taps, args = [], []
    for oy in range(2):
        for ox in range(2):
            zf_p = zf[oy::2, ox::2]
            denom = depth_sigma * torch.clamp(torch.abs(zf_p), min=1e-3)
            for (dy, wy) in ((0, 0.75), (oy * 2 - 1, 0.25)):
                for (dx, wx) in ((0, 0.75), (ox * 2 - 1, 0.25)):
                    taps.append((dy, dx, wy * wx))
                    args.append(-torch.abs(_shift(z_coarse, dy, dx) - zf_p) / denom)
    wzs = exp_xla(torch.stack(args))
    rows = []
    for oy in range(2):
        cols = []
        for ox in range(2):
            acc = torch.zeros((h, w), dtype=torch.float32, device=dev)
            wacc = torch.zeros((h, w), dtype=torch.float32, device=dev)
            for k in range(4 * (2 * oy + ox), 4 * (2 * oy + ox) + 4):
                dy, dx, wyx = taps[k]
                wgt = wyx * (wzs[k] + 1e-4)
                acc = acc + _shift(ao, dy, dx) * wgt
                wacc = wacc + wgt
            cols.append(acc / torch.clamp(wacc, min=1e-6))
        rows.append(torch.stack(cols, dim=-1))
    out = torch.stack(rows, dim=1)                       # [h, oy, w, ox]
    return out.reshape(2 * h, 2 * w)[:fh, :fw]
