"""Texture sampling — counterpart of ``vqengine_tpu/ops/texture.py`` (the
reference's sampler states and Texture2D.Sample calls,
ForwardLighting.hlsl:81-102: linear/point/aniso samplers over 9 material
texture slots).

Two storage layouts, as in the reference:

1. Array-of-textures mip tensors ([N, S, S, 4] f32 per level): the exact
   path (tests, HDR textures).
2. **Quad-packed RGBA8** (`PackedTextures`): each row holds a full 2x2
   bilinear footprint as four RGBA8 texels packed into int32 lanes, stored
   in 4 phase-shifted copies (one per (y0&1, x0&1) parity), so any
   footprint lands in exactly one row; with pair rows, one [8]-lane row
   holds a material's diffuse quad and its combined-aux quad.

The reference picks a tap's level by computing every level's row index
and selecting with `where` (about 25 ops per level per tap). The port
gathers the level's size, quad width and row offset from small device
tables at the tap's level and computes one index: the same f32 products
(uv * s - 0.5) and the same integer index, one level's worth of ops.

Rounding (ROADMAP queue 3): the reference runs op by op on the CPU, so
no multiply-add is contracted across ops. Its `log2` is XLA's `log(x) /
log(2)` (folded into a product with the reciprocal), and XLA's f32 `log` is a Cephes polynomial with every multiply-add
fused (`log_xla` reproduces it bit for bit); its `sqrt` is correctly
rounded (f64 here); `jnp.cross` is one compiled op whose components are
fma(a_i, b_j, -(a_j * b_i)); `jnp.linalg.norm` is an FMA chain
(shadow.norm3). Divisions by a Python number divide by a device scalar
(raster.div_true), because PyTorch on a card multiplies by the reciprocal.
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass

import numpy as np
import torch

from . import sparse
from .raster import _fma, div_true, scalar_on
from .shadow import _sqrt, dot3, norm3

# Adaptive-aniso-walk activation ladder, scored on the UNCLAMPED
# anisotropy ratio (the reference's ANISO_THRS): rungs above the clamp rank
# the clamped tier by true anisotropy; inf is the always-satisfiable "walk
# nothing" top rung. Pixels below the chosen rung keep the aniso-clamped
# single tap.
ANISO_THRS = (1.3, 1.6, 2.0, 2.6, 3.4, 4.4, 5.6, 7.0,
              10.0, 14.0, 20.0, 32.0, 64.0, 256.0, float("inf"))


@dataclass(frozen=True)
class PackedTextures:
    """Quad-packed RGBA8 texture array (layout 2 above), on one device.
    flat[q] = [c(y0,x0), c(y0,x1), c(y1,x0), c(y1,x1)] as packed RGBA8
    int32; per level the quads lay out as [N, py, px, Qy, Qx, 4] with
    wrap-around baked into the edge quads at pack time.

    pair_flat (optional): pair-packed rows [QP, 8], lanes 0..3 a
    material's diffuse quad and lanes 4..7 its combined-aux quad, for each
    (diffuse, aux) pair (TextureManager.combine_pair_quads).

    level_size [L] f32 and level_int [L, 4] int64 (size, quad width, row
    offset, pair row offset) are the per-level tables a tap gathers at its
    level."""
    flat: torch.Tensor                                 # [Q, 4] int32
    offs: tuple = ()
    sizes: tuple = ()
    pair_flat: torch.Tensor | None = None              # [QP, 8] int32
    pair_offs: tuple = ()
    level_size: torch.Tensor | None = None             # [L] f32
    level_int: torch.Tensor | None = None              # [L, 4] int64

    def to(self, device) -> "PackedTextures":
        """The same tables, bit for bit, on `device`."""
        return dataclasses.replace(
            self, flat=self.flat.to(device),
            pair_flat=None if self.pair_flat is None else self.pair_flat.to(device),
            level_size=self.level_size.to(device),
            level_int=self.level_int.to(device))


def _level_tables(sizes, offs, pair_offs, device):
    n = len(sizes)
    pair = list(pair_offs) if pair_offs else [0] * n
    ints = np.asarray([[s, (s + 1) // 2, offs[m], pair[m]]
                       for m, s in enumerate(sizes)], np.int64)
    return (torch.tensor(np.asarray(sizes, np.float32), device=device),
            torch.from_numpy(ints).to(device))


def _pack_rgba8(src: np.ndarray) -> np.ndarray:
    u8 = np.clip(np.rint(np.asarray(src, np.float32) * 255.0),
                 0, 255).astype(np.uint32)
    return (u8[..., 0] | (u8[..., 1] << 8)
            | (u8[..., 2] << 16) | (u8[..., 3] << 24))


def _quads(images: list, s: int) -> np.ndarray:
    """[n, s, s] packed texels per image -> [n, 2, 2, q, q, 4 * len(images)]
    uint32: each image's 2x2 footprint in four lanes, per parity copy."""
    q = (s + 1) // 2
    n = images[0].shape[0]
    quad = np.zeros((n, 2, 2, q, q, 4 * len(images)), np.uint32)
    base = np.arange(q) * 2
    for py in range(2):
        y0 = (base + py) % s
        y1 = (base + py + 1) % s
        for px in range(2):
            x0 = (base + px) % s
            x1 = (base + px + 1) % s
            for k, img in enumerate(images):
                lane = 4 * k
                quad[:, py, px, :, :, lane + 0] = img[:, y0][:, :, x0]
                quad[:, py, px, :, :, lane + 1] = img[:, y0][:, :, x1]
                quad[:, py, px, :, :, lane + 2] = img[:, y1][:, :, x0]
                quad[:, py, px, :, :, lane + 3] = img[:, y1][:, :, x1]
    return quad


def pack_texture_quads(levels: list[np.ndarray], device) -> PackedTextures:
    """levels: per mip [N, s, s, 4] f32 in [0, 1] -> PackedTextures on
    `device`."""
    parts, offs, sizes = [], [], []
    off = 0
    for lvl in levels:
        s = lvl.shape[1]
        parts.append(_quads([_pack_rgba8(lvl)], s).reshape(-1, 4).view(np.int32))
        offs.append(off)
        sizes.append(s)
        off += parts[-1].shape[0]
    size_t, int_t = _level_tables(sizes, offs, (), device)
    return PackedTextures(flat=torch.from_numpy(np.concatenate(parts)).to(device),
                          offs=tuple(offs), sizes=tuple(sizes),
                          level_size=size_t, level_int=int_t)


def pack_texture_pairs(levels: list[np.ndarray], pairs: list[tuple],
                       packed: PackedTextures) -> PackedTextures:
    """`packed` with pair rows for each (diffuse_id, aux_id) pair: one
    [QP, 8] row per 2x2 footprint holding both quads. ids of -1 take a
    neutral image (diffuse white; aux = flat normal, unit roughness and
    metalness multipliers)."""
    parts, offs = [], []
    off = 0
    for lvl in levels:
        n, s = lvl.shape[0], lvl.shape[1]
        lvl = np.asarray(lvl, np.float32)
        neutral_d = np.ones((1, s, s, 4), np.float32)
        neutral_a = np.empty((1, s, s, 4), np.float32)
        neutral_a[..., 0:2] = 0.5
        neutral_a[..., 2:4] = 1.0
        pk = _pack_rgba8(np.concatenate([lvl, neutral_d, neutral_a], axis=0))
        d_sel = np.asarray([p[0] if p[0] >= 0 else n for p in pairs])
        a_sel = np.asarray([p[1] if p[1] >= 0 else n + 1 for p in pairs])
        parts.append(_quads([pk[d_sel], pk[a_sel]], s).reshape(-1, 8).view(np.int32))
        offs.append(off)
        off += parts[-1].shape[0]
    device = packed.flat.device
    size_t, int_t = _level_tables(packed.sizes, packed.offs, offs, device)
    return dataclasses.replace(
        packed, pair_flat=torch.from_numpy(np.concatenate(parts)).to(device),
        pair_offs=tuple(offs), level_size=size_t, level_int=int_t)


# ---------------------------------------------------------------------------
# the reference's roundings
# ---------------------------------------------------------------------------

_LOG_P = tuple(float(np.float32(p)) for p in (
    7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1, -1.2420140846E-1,
    1.4249322787E-1, -1.6668057665E-1, 2.0000714765E-1, -2.4999993993E-1,
    3.3333331174E-1))
_LOG_Q1 = float(np.float32(-2.12194440e-4))
_LOG_Q2 = float(np.float32(0.693359375))
# XLA folds the division by its f32 log(2) into a product with the f32
# reciprocal
_INV_LN2 = float(np.float32(1.0) / np.float32(np.log(2.0)))
_MIN_NORM = float(np.float32(1.17549435e-38))


def log_xla(x: torch.Tensor) -> torch.Tensor:
    """f32 natural log, bit for bit as XLA's CPU backend computes the
    reference's jnp.log: the Cephes polynomial of XLA's vectorized log with
    every multiply-add fused (0 of 1,000,000 random inputs over [1e-6, 1e4]
    differ; torch's log differs on 3.6%), for x > 0 (the callers clamp)."""
    x = torch.clamp(x, min=_MIN_NORM)
    bits = x.view(torch.int32)
    e = ((bits >> 23) - 0x7e).to(torch.float32)       # 1 + (exponent - 127)
    m = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)   # [0.5, 1)
    small = m < float(np.float32(0.707106781186547524))
    e = e - small.to(torch.float32)
    t = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    x2 = t * t
    x3 = x2 * t
    p = _LOG_P
    y = _fma(_fma(t, p[0], p[1]), t, p[2])
    y1 = _fma(_fma(t, p[3], p[4]), t, p[5])
    y2 = _fma(_fma(t, p[6], p[7]), t, p[8])
    y = _fma(y, x3, y1)
    y = _fma(y, x3, y2)
    y = _fma(y, x3, e * _LOG_Q1)
    t = t - x2 * 0.5
    t = t + y
    return t + e * _LOG_Q2


def log2_xla(x: torch.Tensor) -> torch.Tensor:
    """The reference's jnp.log2 on the CPU: log(x) / log(2), which XLA
    computes as log(x) * f32(1 / log(2)) (0 of 2,000,000 inputs differ)."""
    return log_xla(x) * _INV_LN2


# XLA's vectorized f32 exp (the Cephes polynomial): its clamp, log2(e),
# the two-part ln 2 and the coefficients, as f32 values
_EXP_LO, _EXP_HI = float(np.float32(-87.8)), float(np.float32(88.8))
_LOG2E = float(np.float32(1.44269504088896341))
_EXP_C1, _EXP_C2 = 0.693359375, float(np.float32(-2.12194440e-4))
_EXP_P = tuple(float(np.float32(p)) for p in (
    1.9875691500E-4, 1.3981999507E-3, 8.3334519073E-3, 4.1665795894E-2,
    1.6666665459E-1, 5.0000001201E-1))


def exp_xla(x: torch.Tensor) -> torch.Tensor:
    """f32 exp, bit for bit as XLA's CPU backend computes the reference's
    jnp.exp: x clamped to [-87.8, 88.8], n = floor(x log2(e) + 1/2) clamped
    to [-127, 127], the Cephes polynomial in x - n ln 2 with every
    multiply-add fused, times 2^n built from its bits (0 for n = -127), and
    a result below the smallest normal flushed to 0 (XLA's CPU threads
    flush denormals). 0 of 2,500,000 inputs over [-100, 100] differ, torch's
    exp on 23.5% of them (tools/rounding_probes_torch.py)."""
    x = torch.clamp(x, _EXP_LO, _EXP_HI)
    n = torch.clamp(torch.floor(_fma(x, _LOG2E, 0.5)), -127.0, 127.0)
    x = _fma(n, -_EXP_C1, x)
    x = _fma(n, -_EXP_C2, x)
    y = _fma(x, _EXP_P[0], _EXP_P[1])
    for p in _EXP_P[2:]:
        y = _fma(y, x, p)
    y = 1.0 + _fma(y, x * x, x)
    r = y * ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    return torch.where(r < _MIN_NORM, 0.0, r)


def _floor_index(x: torch.Tensor, hi: int) -> torch.Tensor:
    """clip(int(floor(x)), 0, hi) as the reference's floor, int32 cast
    (NaN to 0, saturating) and clip -> int64."""
    return torch.clamp(torch.floor(torch.nan_to_num(x, nan=0.0)), 0.0,
                       float(hi)).to(torch.int64)


def _to_int(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 -> int32 conversion of integral x (NaN to 0, saturating)
    -> int64."""
    x = torch.clamp(torch.nan_to_num(x, nan=0.0), -2.0 ** 31, 2.0 ** 31)
    return x.to(torch.int64).clamp(max=2 ** 31 - 1)


# ---------------------------------------------------------------------------
# taps
# ---------------------------------------------------------------------------

def _tap_rows(pt: PackedTextures, tex_id: torch.Tensor, uv: torch.Tensor,
              lodi: torch.Tensor, pair: bool):
    """One bilinear tap's row index at level lodi: (idx int64, fx, fy)."""
    li = lodi.long()
    s = pt.level_size[li]
    ints = pt.level_int[li]
    xy = uv * s[..., None] - 0.5
    xy0 = torch.floor(xy)
    f = xy - xy0
    xy0i = torch.remainder(_to_int(xy0), ints[..., 0:1])
    p = xy0i & 1
    qq = xy0i >> 1
    q = ints[..., 1]
    t = torch.clamp(tex_id, min=0).long()
    idx = ((((t * 2 + p[..., 1]) * 2 + p[..., 0]) * q + qq[..., 1]) * q
           + qq[..., 0] + ints[..., 3 if pair else 2])
    return idx, f[..., 0], f[..., 1]


@functools.cache
def _channel_shifts(device: torch.device) -> torch.Tensor:
    return torch.tensor([0, 8, 16, 24], dtype=torch.int32, device=device)


def _unpack_rgba8(v: torch.Tensor) -> torch.Tensor:
    """[..., k] packed RGBA8 int32 -> [..., k, 4] f32 in [0, 1], each
    channel (v >> 8c) & 0xFF divided by 255 as the reference divides."""
    c = ((v[..., None] >> _channel_shifts(v.device)) & 0xFF).to(torch.float32)
    return div_true(c, scalar_on(255.0, v.device))


def _bilerp_rgba8(w: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor,
                  lane0: int) -> torch.Tensor:
    """Bilinear blend of 4 packed-RGBA8 lanes [..., lane0:lane0+4]."""
    c = _unpack_rgba8(w[..., lane0:lane0 + 4])
    fx = fx[..., None]
    fy = fy[..., None]
    gx = 1 - fx
    top = c[..., 0, :] * gx + c[..., 1, :] * fx
    bot = c[..., 2, :] * gx + c[..., 3, :] * fx
    return top * (1 - fy) + bot * fy


def _packed_pair_tap(pt: PackedTextures, pair_id: torch.Tensor,
                     uv: torch.Tensor, lodi: torch.Tensor):
    """One bilinear tap of a (diffuse, aux) pair: one 8-lane row gather ->
    (diffuse rgba, aux rgba)."""
    idx, fx, fy = _tap_rows(pt, pair_id, uv, lodi, pair=True)
    rows = pt.pair_flat[idx]
    return _bilerp_rgba8(rows, fx, fy, 0), _bilerp_rgba8(rows, fx, fy, 4)


def _packed_tap(pt: PackedTextures, tex_id: torch.Tensor, uv: torch.Tensor,
                lodi: torch.Tensor) -> torch.Tensor:
    """One bilinear tap from the quad-packed table: one row gather."""
    idx, fx, fy = _tap_rows(pt, tex_id, uv, lodi, pair=False)
    return _bilerp_rgba8(pt.flat[idx], fx, fy, 0)


def _mix(a: torch.Tensor, b: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return a * (1 - w) + b * w


def sample_texture_pair_aniso(pt: PackedTextures, pair_id: torch.Tensor,
                              diffuse_id: torch.Tensor, uv: torch.Tensor,
                              num_taps: int = 8, max_aniso: float = 8.0,
                              jitter: torch.Tensor | None = None,
                              adaptive_frac: int | None = 16,
                              telemetry: dict | None = None):
    """Anisotropic (diffuse, aux) sample from the pair-packed table: one
    dense pair-row tap at the aniso-clamped level covers the diffuse base
    tap and the combined-aux tap; the most anisotropic pixels (the ladder's
    rung, within the capacity) then refine the diffuse channel with the
    compacted ellipse walk. -> (diffuse rgba, aux rgba)."""
    max_lod = tex_num_levels(pt) - 1
    lod_m, major, ratio, ratio_raw = uv_mip_level_aniso(
        uv, tex_base_size(pt), max_lod, max_aniso=max_aniso)
    lod1 = torch.clamp(lod_m + log2_xla(torch.clamp(ratio, min=1.0)), 0.0,
                       float(max_lod))
    if jitter is not None:
        diffuse, aux = _packed_pair_tap(pt, pair_id, uv,
                                        _floor_index(lod1 + jitter, max_lod))
    else:
        l0 = _floor_index(lod1, max_lod)
        l1 = torch.clamp(l0 + 1, max=max_lod)
        wgt = torch.clamp(lod1 - l0.to(torch.float32), 0.0, 1.0)[..., None]
        d0, a0 = _packed_pair_tap(pt, pair_id, uv, l0)
        d1, a1 = _packed_pair_tap(pt, pair_id, uv, l1)
        diffuse, aux = _mix(d0, d1, wgt), _mix(a0, a1, wgt)
    if num_taps <= 1 or adaptive_frac is None:
        return diffuse, aux
    return _adaptive_walk(pt, diffuse, diffuse_id, uv, major, ratio, ratio_raw,
                          lod_m, num_taps, jitter, adaptive_frac,
                          telemetry), aux


def _adaptive_walk(pt, base, tex_id, uv, major, ratio, ratio_raw, lod,
                   num_taps: int, jitter, adaptive_frac: int,
                   telemetry: dict | None) -> torch.Tensor:
    """The compacted ellipse walk over the pixels above the ladder's rung
    (cap = frame / adaptive_frac lanes, at least 512, in 8-pixel blocks),
    written over `base` where live."""
    n = ratio.numel()
    cap = -(-max(512, n // adaptive_frac) // 8) * 8
    thr, _ = sparse.adaptive_threshold(ratio_raw, ANISO_THRS, cap, block=8)
    active = ratio_raw > thr
    idx, count, demand = sparse.compact_indices(active, cap, block=8)
    if telemetry is not None:
        telemetry["tex_aniso"] = div_true(demand.to(torch.float32), cap)
        telemetry["tex_aniso_demand"] = div_true(
            sparse.block_count(ratio_raw > ANISO_THRS[0], 8).to(torch.float32) * 8,
            cap)
    live = ((torch.arange(cap, device=idx.device) < count)
            & active.reshape(-1)[idx])

    def g(v):
        return v.reshape((-1,) + v.shape[ratio.ndim:])[idx]

    out_c = _aniso_taps(pt, g(tex_id), g(uv), g(major), g(ratio), g(lod),
                        num_taps, None if jitter is None else g(jitter))
    nc = base.shape[-1]
    ext = torch.cat([base.reshape(-1, nc), base.new_zeros((1, nc))])
    ext.index_put_((torch.where(live, idx, n),), out_c)
    return ext[:n].reshape(base.shape)


def sample_texture_pair(pt: PackedTextures, pair_id: torch.Tensor,
                        uv: torch.Tensor, lod: torch.Tensor,
                        jitter: torch.Tensor | None = None):
    """Trilinear (diffuse, aux) pair sample at a precomputed isotropic lod:
    a stochastic single tap with jitter, else the 2-tap mip blend."""
    max_lod = len(pt.sizes) - 1
    if jitter is not None:
        return _packed_pair_tap(pt, pair_id, uv, _floor_index(lod + jitter, max_lod))
    l0 = _floor_index(lod, max_lod)
    l1 = torch.clamp(l0 + 1, max=max_lod)
    w = torch.clamp(lod - l0.to(torch.float32), 0.0, 1.0)[..., None]
    d0, a0 = _packed_pair_tap(pt, pair_id, uv, l0)
    d1, a1 = _packed_pair_tap(pt, pair_id, uv, l1)
    return _mix(d0, d1, w), _mix(a0, a1, w)


def uv_gradients(uv: torch.Tensor):
    """Screen-space uv derivative vectors (the hardware ddx/ddy), edge-
    clamped backward differences over the first two axes: uv [H, W, 2] ->
    (duv_dx, duv_dy)."""
    duv_dx = uv - torch.cat([uv[:, :1], uv[:, :-1]], dim=1)
    duv_dy = uv - torch.cat([uv[:1], uv[:-1]], dim=0)
    return duv_dx, duv_dy


def _sq2(d: torch.Tensor) -> torch.Tensor:
    """(d ** 2).sum(-1) of two components."""
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]


def uv_mip_level(uv: torch.Tensor, tex_size: int, max_mip: int,
                 bias: torch.Tensor | float = 0.0) -> torch.Tensor:
    """Per-pixel LOD from screen-space uv derivatives: uv [H, W, 2] -> lod
    [H, W]."""
    duv_dx, duv_dy = uv_gradients(uv)
    rho = _sqrt(torch.maximum(_sq2(duv_dx), _sq2(duv_dy)))
    lod = log2_xla(torch.clamp(rho * float(tex_size), min=1e-6)) + bias
    return torch.clamp(lod, 0.0, float(max_mip))


def uv_mip_level_aniso(uv: torch.Tensor, tex_size: int, max_mip: int,
                       max_aniso: float = 4.0,
                       bias: torch.Tensor | float = 0.0):
    """Anisotropic LOD (the AnisoSampler's footprint math): LOD follows the
    minor axis of the footprint ellipse and the taps march along the major
    axis. -> (lod [H, W], major step [H, W, 2] in uv, ratio [H, W] clamped
    to max_aniso, the unclamped ratio [H, W])."""
    duv_dx, duv_dy = uv_gradients(uv)
    lx = _sqrt(_sq2(duv_dx))
    ly = _sqrt(_sq2(duv_dy))
    major_is_x = lx >= ly
    rho_maj = torch.clamp(torch.maximum(lx, ly), min=1e-12)
    rho_min = torch.clamp(torch.minimum(lx, ly), min=1e-12)
    ratio_raw = rho_maj / rho_min
    ratio = torch.clamp(ratio_raw, max=max_aniso)
    lod = log2_xla(torch.clamp(rho_maj / ratio * float(tex_size), min=1e-6)) + bias
    major = torch.where(major_is_x[..., None], duv_dx, duv_dy)
    return torch.clamp(lod, 0.0, float(max_mip)), major, ratio, ratio_raw


def _flatten_mips(mips: list[torch.Tensor]):
    """All (texture, mip) levels as one [M, 4] row table and the levels'
    row offsets."""
    offs, off = [], 0
    for level in mips:
        offs.append(off)
        off += level.shape[0] * level.shape[1] * level.shape[1]
    return torch.cat([level.reshape(-1, 4) for level in mips]), offs


def _bilinear_indices(mips, offs, t, uv, lodi):
    """Per-pixel flat-table corner indices and filter fractions at the int
    level map lodi -> (i00, i10, i01, i11, fx, fy)."""
    li = lodi.long()
    sizes = torch.tensor([m.shape[1] for m in mips], device=uv.device)
    s = sizes[li]
    xy = uv * s.to(torch.float32)[..., None] - 0.5
    xy0 = torch.floor(xy)
    f = xy - xy0
    i0 = torch.remainder(_to_int(xy0), s[..., None])
    i1 = torch.remainder(i0 + 1, s[..., None])
    base = torch.tensor(offs, device=uv.device)[li] + t.long() * (s * s)
    x0i, y0i, x1i, y1i = i0[..., 0], i0[..., 1], i1[..., 0], i1[..., 1]
    return (base + y0i * s + x0i, base + y0i * s + x1i,
            base + y1i * s + x0i, base + y1i * s + x1i,
            f[..., 0:1], f[..., 1:2])


def _bilinear_fetch(flat, idx):
    i00, i10, i01, i11, fx, fy = idx
    c00, c10, c01, c11 = (flat[i].to(torch.float32) for i in (i00, i10, i01, i11))
    return (c00 * (1 - fx) * (1 - fy) + c10 * fx * (1 - fy)
            + c01 * (1 - fx) * fy + c11 * fx * fy)


def tex_base_size(textures) -> int:
    """Base (level 0) texel size for either storage layout."""
    if isinstance(textures, PackedTextures):
        return textures.sizes[0]
    return textures[0].shape[1]


def tex_num_levels(textures) -> int:
    if isinstance(textures, PackedTextures):
        return len(textures.sizes)
    return len(textures)


def mip_jitter(h: int, w: int, y_offset=0, device=None) -> torch.Tensor:
    """Per-pixel R2 low-discrepancy jitter in [0, 1) for stochastic
    trilinear, as the reference computes it in f32. y_offset shifts the
    pattern to a screen band's frame rows, so that the bands dither as the
    whole frame does."""
    g = 1.32471795724474602596  # plastic constant
    a1, a2 = float(np.float32(1.0 / g)), float(np.float32(1.0 / (g * g)))
    xs = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    ys = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    if y_offset:
        ys = ys + y_offset
    return torch.remainder(xs * a1 + ys * a2, 1.0)


def sample_texture_array(mips, tex_id: torch.Tensor, uv: torch.Tensor,
                         lod: torch.Tensor | None = None,
                         trilinear: bool = True,
                         jitter: torch.Tensor | None = None) -> torch.Tensor:
    """Mip-mapped sample: mips a list of [N, s_m, s_m, 4] levels or a
    PackedTextures; tex_id [...] (negative = slot unused; callers mask),
    uv [..., 2] -> rgba [..., 4]. Trilinear by default (a stochastic single
    tap at floor(lod + jitter) with jitter), nearest-mip bilinear with
    trilinear=False."""
    if lod is None:
        lod = uv_mip_level(uv, tex_base_size(mips), tex_num_levels(mips) - 1)
    max_m = tex_num_levels(mips) - 1
    if isinstance(mips, PackedTextures):
        def tap(lodi):
            return _packed_tap(mips, tex_id, uv, lodi)
    else:
        flat, offs = _flatten_mips(mips)
        t = torch.clamp(tex_id, min=0)

        def tap(lodi):
            return _bilinear_fetch(flat, _bilinear_indices(mips, offs, t, uv, lodi))
    if jitter is not None and trilinear:
        return tap(_floor_index(lod + jitter, max_m))
    if not trilinear:
        return tap(_floor_index(lod, max_m))       # lod >= 0: trunc = floor
    l0 = _floor_index(lod, max_m)
    l1 = torch.clamp(l0 + 1, max=max_m)
    w = torch.clamp(lod - l0.to(torch.float32), 0.0, 1.0)[..., None]
    return _mix(tap(l0), tap(l1), w)


def _aniso_taps(mips, tex_id, uv, major, ratio, lod_minor, num_taps: int,
                jitter):
    """num_taps trilinear taps along the major footprint axis, uniform
    weights; the LOD clamps up when the taps cannot cover the ellipse.
    Shape-blind: dense images or compacted lanes."""
    span = torch.clamp(ratio, max=float(num_taps))
    lod = lod_minor + log2_xla(torch.clamp(ratio / span, min=1.0))
    lod = torch.clamp(lod, 0.0, float(tex_num_levels(mips) - 1))
    step = torch.clamp(ratio, min=1e-6)
    acc = None
    for i in range(num_taps):
        f = (i + 0.5) / num_taps - 0.5
        uv_i = uv + major * (span * f / step)[..., None]
        jit_i = (None if jitter is None
                 else torch.remainder(jitter + i / num_taps, 1.0))
        c = sample_texture_array(mips, tex_id, uv_i, lod=lod, jitter=jit_i)
        acc = c if acc is None else acc + c
    return div_true(acc, float(num_taps))


def sample_texture_array_aniso(mips, tex_id: torch.Tensor, uv: torch.Tensor,
                               num_taps: int = 2, max_aniso: float = 8.0,
                               jitter: torch.Tensor | None = None,
                               adaptive_frac: int | None = None,
                               telemetry: dict | None = None) -> torch.Tensor:
    """Anisotropic sample (the AnisoSampler): trilinear taps along the
    major footprint axis with LOD from the minor axis. With adaptive_frac
    (and more than 2 taps) one dense tap at the isotropically clamped LOD
    covers every pixel and the compacted walk refines the most anisotropic
    (as sample_texture_pair_aniso); else num_taps dense taps."""
    max_lod = tex_num_levels(mips) - 1
    lod, major, ratio, ratio_raw = uv_mip_level_aniso(
        uv, tex_base_size(mips), max_lod, max_aniso=max_aniso)
    if adaptive_frac is None or num_taps <= 2:
        return _aniso_taps(mips, tex_id, uv, major, ratio, lod, num_taps, jitter)
    lod1 = torch.clamp(lod + log2_xla(torch.clamp(ratio, min=1.0)), 0.0,
                       float(max_lod))
    base = sample_texture_array(mips, tex_id, uv, lod=lod1, jitter=jitter)
    return _adaptive_walk(mips, base, tex_id, uv, major, ratio, ratio_raw, lod,
                          num_taps, jitter, adaptive_frac, telemetry)


def cross_xla(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """jnp.cross over the last axis as XLA compiles it on the CPU: each
    component fma(a_i, b_j, -(a_j * b_i))."""
    out = [_fma(a[..., i], b[..., j], -(a[..., j] * b[..., i]))
           for i, j in ((1, 2), (2, 0), (0, 1))]
    return torch.stack(out, dim=-1)


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(norm3(v), min=1e-9)[..., None]


def unpack_normal_map_xy(sampled_xy: torch.Tensor, world_normal: torch.Tensor,
                         world_tangent: torch.Tensor) -> torch.Tensor:
    """unpack_normal_map for the combined-aux layout: only x, y stored (z =
    sqrt(1 - x^2 - y^2))."""
    xy = sampled_xy * 2.0 - 1.0
    z = _sqrt(torch.clamp(1.0 - _sq2(xy), min=0.0))[..., None]
    return unpack_normal_map(torch.cat([xy, z], dim=-1) * 0.5 + 0.5,
                             world_normal, world_tangent)


def unpack_normal_map(sampled: torch.Tensor, world_normal: torch.Tensor,
                      world_tangent: torch.Tensor) -> torch.Tensor:
    """UnpackNormal (ShadingMath.hlsl:44-52): tangent-space normal map ->
    world space via the Gram-Schmidt TBN."""
    n_ts = sampled * 2.0 - 1.0
    n = _unit(world_normal)
    t = world_tangent - dot3(n, world_tangent)[..., None] * n
    t = _unit(t)
    b = _unit(cross_xla(t, n))
    out = n_ts[..., 0:1] * t + n_ts[..., 1:2] * b + n_ts[..., 2:3] * n
    return _unit(out)
