"""Tile rasterizer: triangle setup, record packing, tile binning, the
G-buffer raster (kernel K1) and the visibility raster (kernel K2).

Counterpart of ``vqengine_tpu/ops/raster.py``; the design is the same
clipless homogeneous-edge rasterizer (see that module's docstring):
per-triangle records are binned into 16x128-pixel tiles, and each tile
streams its records in groups of 128, depth-testing every pixel against
each record's three edge planes and depth plane.

What must stay exactly as in the reference, because the winner of a
depth tie depends on it:
- stream order: global tier, then tile-row tier, then tile tier, each in
  the sorted pair order (ascending triangle id within a bin);
- segment bounds rounded out to whole groups of 128 records over the one
  sorted pair array, with killed records as padding;
- the split-eval plane arithmetic (bf16 hi/lo parts against tile-local
  pixel coordinates, +2^-15 edge bias), evaluated with the same order of
  additions and the same fused multiply-adds (the reference's kernel
  bodies are compiled on the CPU, which contracts some of them).

Ported: K1 in its non-MSAA and MSAA 4x variants, each unbounded and
depth-bounded (the depth-peeling primitive of the transparent pass and
the alpha-mask peel), K2's center (the shadow-map raster) and MSAA 4x
variants, and the record evaluation the MSAA edge resolve runs outside
the kernels.
Records here are pair-major ``[P, 32]`` (K1) or ``[P, 16]`` (K2) rows; the
reference stores ``[NG, R, 128]`` lane blocks of the same values.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from . import _backend
from .palette import palette_lookup

TILE_H = 16
TILE_W = 128
GROUP = 128           # records per streamed group
K_MAX_DEFAULT = 16    # max tiles a tile-tier triangle may cover
GLOBAL_CAP = 512      # capacity of the (always empty) global tier
BG_ID = -1
NPX = TILE_H * TILE_W

PAIR_ROWS = 16        # K2 record rows: e'0..2 (9) dp (3) id (1) pad (3)
GBUF_ROWS = 32        # G-buffer record rows (layout in the reference)
SEL_ROWS = 30         # rows read back for the winner's resolve
GBUF_VATTR = 5        # per-vertex attr rows: packed nrm/tan(3) uv(2)
NRM_PACK_BIAS = 3.0
GBUF_OUT = 16         # nrm(3) tan(3) uv(2) mid obj item, padded to 16
EDGE_BIAS = 2.0 ** -15
# D3D standard 4x MSAA sample offsets (dx, dy) from the pixel center, in
# pixels (the reference renders fixed 4x MSAA)
MSAA4_OFFSETS = ((-2 / 16, -6 / 16), (6 / 16, -2 / 16),
                 (-6 / 16, 2 / 16), (2 / 16, 6 / 16))
MSAA_KEY_CLEAR = 4.0  # K1-MSAA's depth-key carry: above z and z + 1


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _fma(a, b, c) -> torch.Tensor:
    """a*b + c rounded once, as a fused multiply-add: the f32 product is
    exact in f64, so only the f64 sum and the final f32 rounding remain
    (equal to a true FMA except for rare double-rounding ties). Each
    argument is an f32 tensor or a number exact in f32."""
    def d(v):
        return v.double() if isinstance(v, torch.Tensor) else v
    return (d(a) * d(b) + d(c)).float()


def scalar_on(x, device) -> torch.Tensor:
    """A Python number as a 0-d f32 tensor on `device`, filled there (no
    host-to-device copy, so no device sync)."""
    return torch.full((), float(x), dtype=torch.float32, device=device)


def div_true(a, b) -> torch.Tensor:
    """a / b rounded once, as the reference divides (a Python number
    becomes a device scalar: on a card PyTorch turns x / c into x * (1 / c),
    which rounds otherwise unless c is a power of two)."""
    if not isinstance(a, torch.Tensor):
        a = scalar_on(a, b.device)
    if not isinstance(b, torch.Tensor):
        b = scalar_on(b, a.device)
    return a / b


def sample_offset(a: torch.Tensor, b: torch.Tensor, dx: float,
                  dy: float) -> torch.Tensor:
    """a*dx + b*dy for a sample offset (dx, dy), rounded as the reference's
    K2-msaa4 rounds it on the CPU (its interpret-mode body is compiled,
    and XLA contracts the first product into a fused
    multiply-add where its constant is positive; a product with a
    negative constant rounds on its own). For MSAA4_OFFSETS that is an
    FMA in sample 1 and two rounded products in samples 0, 2 and 3
    (where one of the two products is exact, dx or dy being +-1/8)."""
    if dx > 0:
        return _fma(a, torch.full_like(a, dx), b * dy)
    return a * dx + b * dy


# K1-MSAA's threshold t = -(e_x dx + e_y dy) of edge i at sample s rounds
# once (the inexact product fused into the sum) or twice (both products
# rounded), as the reference's compiled kernel body contracts it on the
# CPU; it contracts the same expression one way where it sets the sticky
# coverage bits and another where it tests "some sample covered" for the
# depth key. [sample][edge] -> fused, measured per sample and edge with
# the crafted records of raster_probes.py (neither is sample_offset's
# rule).
MSAA_COVERAGE_FUSED = ((True, False, False), (True, True, True),
                       (False, False, False), (True, False, False))
MSAA_KEY_FUSED = ((True, False, False), (False, False, False),
                  (False, False, False), (True, False, False))


def msaa_threshold(a: torch.Tensor, b: torch.Tensor, s: int,
                   fused: bool) -> torch.Tensor:
    """-(a*dx + b*dy) for sample s of MSAA4_OFFSETS, rounded once (fused)
    or as two rounded products added."""
    dx, dy = MSAA4_OFFSETS[s]
    if fused:
        return -(a.double() * dx + b.double() * dy).float()
    return -(a * dx + b * dy)


def matvec_fma(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[..., I, J] x [..., J] -> [..., I], rounded as XLA's CPU backend
    rounds the reference's batched einsum "cij,cj->ci": a chain of fused
    multiply-adds over j (_fma). XLA's accumulator starts at +0, so a sum
    of -0 products is +0 (the closing + 0.0; nothing else changes)."""
    acc = m[..., 0] * v[..., None, 0]
    for j in range(1, m.shape[-1]):
        acc = _fma(m[..., j], v[..., None, j], acc)
    return acc + 0.0


def world_view_proj(vp: torch.Tensor, world: torch.Tensor) -> torch.Tensor:
    """vp [4, 4] x world [N, 4, 4] -> [N, 4, 4] (the reference's einsum
    "ij,njk->nik"), the four products summed in pairs as XLA sums that
    einsum on the CPU."""
    t = [vp[None, :, j, None] * world[:, None, j, :] for j in range(4)]
    return (t[0] + t[1]) + (t[2] + t[3])


# ===========================================================================
# 1+2. vertex transform & triangle setup
# ===========================================================================

def transform_clip_corners(corner_positions: torch.Tensor,
                           tri_item: torch.Tensor,
                           mvps: torch.Tensor) -> torch.Tensor:
    """corner_positions [3T, 3], tri_item [T] int32, mvps [N, 4, 4] ->
    clip corners [T, 3, 4]; the per-corner matrix fetch is a palette
    lookup."""
    t = tri_item.shape[0]
    n = mvps.shape[0]
    item3 = tri_item.repeat_interleave(3)
    m = palette_lookup(item3, mvps.reshape(n, 16).contiguous()).reshape(-1, 4, 4)
    p = torch.cat([corner_positions,
                   torch.ones_like(corner_positions[:, :1])], dim=1)
    return matvec_fma(m, p).reshape(t, 3, 4)


def transform_clip_corners_morph(corner_positions: torch.Tensor,
                                 corner_morph_mid: torch.Tensor,
                                 tri_item: torch.Tensor,
                                 mvps: torch.Tensor,
                                 morph_w: torch.Tensor) -> torch.Tensor:
    """transform_clip_corners with the geomorph: each corner lerps toward
    its morph target by its item's factor morph_w [N] in [0, 1] (1 = full
    detail) before the clip transform. The factor rides the matrix's
    palette row: one K3 lookup of [3T, 17] rows. Meshes without morph data
    carry mid == position, so the lerp leaves them as they are."""
    t = tri_item.shape[0]
    n = mvps.shape[0]
    item3 = tri_item.repeat_interleave(3)
    table = torch.cat([mvps.reshape(n, 16),
                       morph_w.to(torch.float32)[:, None]], dim=1)
    rows = palette_lookup(item3, table)                       # [3T, 17]
    m = rows[:, :16].reshape(-1, 4, 4)
    w = rows[:, 16:17]
    pos = corner_morph_mid + w * (corner_positions - corner_morph_mid)
    p = torch.cat([pos, torch.ones_like(pos[:, :1])], dim=1)
    return matvec_fma(m, p).reshape(t, 3, 4)


def transform_clip_instanced(positions: torch.Tensor,
                             item_of_vertex: torch.Tensor,
                             mvps: torch.Tensor) -> torch.Tensor:
    """positions [V, 3], item_of_vertex [V] int32, mvps [N, 4, 4] ->
    clip [V, 4]; the per-vertex matrix fetch is a palette lookup."""
    n = mvps.shape[0]
    m = palette_lookup(item_of_vertex,
                       mvps.reshape(n, 16).contiguous()).reshape(-1, 4, 4)
    p = torch.cat([positions, torch.ones_like(positions[:, :1])], dim=1)
    return matvec_fma(m, p)


@dataclass(frozen=True)
class TriangleSetup:
    """Per-triangle raster data (all [T, ...]); see the reference."""
    edges9: torch.Tensor      # [T, 9] homogeneous edge rows
    zc: torch.Tensor          # [T, 3] z_i / det
    vert_scale: torch.Tensor  # [T, 3] 1/|w_i| conditioning scales
    valid: torch.Tensor       # [T] bool: front-facing and on screen
    tile_lo: torch.Tensor     # [T, 2] (tx0, ty0) int32
    tile_hi: torch.Tensor     # [T, 2] (tx1, ty1) int32, inclusive
    big: torch.Tensor         # [T] bool: global tier (always False)


def setup_triangles(c: torch.Tensor, width: int, height: int,
                    tri_mask: torch.Tensor | None = None,
                    full_height: int | None = None,
                    y_offset: int = 0) -> TriangleSetup:
    """Clip corners [T, 3, 4] -> TriangleSetup. Mirrors the reference's
    arithmetic operation for operation. A screen band (parallel/
    multichip.py): `height` is the band's, full_height the frame's and
    y_offset the band's first row; the viewport shifts by y_offset * w
    (linear in w, so the edge and depth planes stay exact)."""
    fh = height if full_height is None else full_height
    x = [c[:, i, 0] for i in range(3)]
    y = [c[:, i, 1] for i in range(3)]
    z = [c[:, i, 2] for i in range(3)]
    w = [c[:, i, 3] for i in range(3)]
    s, xs, ys, ws, zs, xs_u, ys_u = [], [], [], [], [], [], []
    for i in range(3):
        si = 1.0 / torch.clamp(w[i].abs(), min=1e-9)
        xsi = (x[i] * 0.5 + w[i] * 0.5) * width
        ysi = (-y[i] * 0.5 + w[i] * 0.5) * fh
        if y_offset:
            ysi = ysi - y_offset * w[i]
        s.append(si)
        xs_u.append(xsi)
        ys_u.append(ysi)
        xs.append(xsi * si)
        ys.append(ysi * si)
        ws.append(w[i] * si)
        zs.append(z[i] * si)

    def cross(a, b):
        return (ys[a] * ws[b] - ws[a] * ys[b],
                ws[a] * xs[b] - xs[a] * ws[b],
                xs[a] * ys[b] - ys[a] * xs[b])

    e0 = cross(1, 2)
    e1 = cross(2, 0)
    e2 = cross(0, 1)
    det = xs[0] * e0[0] + ys[0] * e0[1] + ws[0] * e0[2]

    front = det > 1e-14
    one = torch.ones_like(det)
    inv_det = torch.where(front, 1.0 / torch.where(front, det, one),
                          torch.zeros_like(det))
    zc = [zs[i] * inv_det for i in range(3)]

    # exact bbox of the visible part (near-plane crossers clipped at
    # w = eps), as in the reference
    eps = 1e-5
    w_ok = [w[i] > eps for i in range(3)]
    any_ok = w_ok[0] | w_ok[1] | w_ok[2]
    all_w_pos = w_ok[0] & w_ok[1] & w_ok[2]
    big_f = torch.full_like(det, 1e9)
    cand_x, cand_y, cand_ok = [], [], []
    for i in range(3):
        wsafe = torch.where(ws[i] != 0, ws[i], one)
        cand_x.append(xs[i] / wsafe)
        cand_y.append(ys[i] / wsafe)
        cand_ok.append(w_ok[i])
    eps_t = torch.full_like(det, eps)
    for a, b in ((0, 1), (1, 2), (2, 0)):
        cross_e = w_ok[a] != w_ok[b]
        denom = w[b] - w[a]
        t = (eps_t - w[a]) / torch.where(denom.abs() > 1e-20, denom,
                                         torch.full_like(det, 1e-20))
        xh = xs_u[a] + t * (xs_u[b] - xs_u[a])
        yh = ys_u[a] + t * (ys_u[b] - ys_u[a])
        cand_x.append(xh / eps_t)
        cand_y.append(yh / eps_t)
        cand_ok.append(cross_e)
    xmin = xmax = ymin = ymax = None
    for cx, cy, ok in zip(cand_x, cand_y, cand_ok):
        lo_x = torch.where(ok, cx, big_f)
        hi_x = torch.where(ok, cx, -big_f)
        lo_y = torch.where(ok, cy, big_f)
        hi_y = torch.where(ok, cy, -big_f)
        xmin = lo_x if xmin is None else torch.minimum(xmin, lo_x)
        xmax = hi_x if xmax is None else torch.maximum(xmax, hi_x)
        ymin = lo_y if ymin is None else torch.minimum(ymin, lo_y)
        ymax = hi_y if ymax is None else torch.maximum(ymax, hi_y)
    pad = torch.where(all_w_pos, torch.zeros_like(det), one)
    xmin, xmax = xmin - pad, xmax + pad
    ymin, ymax = ymin - pad, ymax + pad

    offscreen = (xmax < 0) | (xmin >= width) | (ymax < 0) | (ymin >= height)
    valid = front & any_ok & ~offscreen
    if tri_mask is not None:
        valid = valid & tri_mask
    big = torch.zeros_like(valid)     # the global tier stays empty

    tiles_x = cdiv(width, TILE_W)
    tiles_y = cdiv(height, TILE_H)

    def tile_of(v, size, n):
        return torch.floor(v / size).to(torch.int32).clamp(0, n - 1)

    return TriangleSetup(
        edges9=torch.stack([e0[0], e0[1], e0[2], e1[0], e1[1], e1[2],
                            e2[0], e2[1], e2[2]], dim=1),
        zc=torch.stack(zc, dim=1),
        vert_scale=torch.stack(s, dim=1), valid=valid,
        tile_lo=torch.stack([tile_of(xmin, TILE_W, tiles_x),
                             tile_of(ymin, TILE_H, tiles_y)], dim=1),
        tile_hi=torch.stack([tile_of(xmax, TILE_W, tiles_x),
                             tile_of(ymax, TILE_H, tiles_y)], dim=1),
        big=big,
    )


def band_end(y_offset: int, band_height: int, full_height: int) -> int:
    """The frame rows [0, end) a screen band's raster covers (parallel/
    multichip.py): the band's last row rounded up to whole tiles, at most
    the frame's."""
    return min(full_height, cdiv(y_offset + band_height, TILE_H) * TILE_H)


def rows_of_setup(setup: TriangleSetup, rows: int) -> TriangleSetup:
    """The first `rows` rows of a frame's TriangleSetup as a setup of their
    own: the planes stay the frame's, and the frame's tile rows, cut to
    those rows, bound the tile spans; a triangle whose span starts below
    them is invalid there. A raster of those rows is the frame's bit for
    bit (tile origins, planes and each tile's records the frame's)."""
    tiles_y = cdiv(rows, TILE_H)
    valid = setup.valid & (setup.tile_lo[:, 1] < tiles_y)
    return TriangleSetup(
        edges9=setup.edges9, zc=setup.zc, vert_scale=setup.vert_scale,
        valid=valid,
        tile_lo=torch.stack([setup.tile_lo[:, 0],
                             setup.tile_lo[:, 1].clamp(max=tiles_y - 1)], dim=1),
        tile_hi=torch.stack([setup.tile_hi[:, 0],
                             setup.tile_hi[:, 1].clamp(max=tiles_y - 1)], dim=1),
        big=setup.big)


def rasterize_gbuf_band(binned: BinnedTriangles, width: int,
                        band_height: int, y_offset: int, full_height: int,
                        msaa: bool = False, zbound=None):
    """rasterize_gbuf for a screen band, the rows [y_offset, y_offset +
    band_height) of a full_height-tall frame: binned is the frame's
    binning of its rows [0, band_end(...)) (bin_triangles on
    rows_of_setup), rastered on those rows and cut to the band's, which
    are then the frame's bit for bit. zbound windows are the band's
    [band_height, W]; the rows above and below get the empty window
    (2, 2). A whole frame (y_offset 0, band_height full_height) is
    rasterize_gbuf's."""
    end = band_end(y_offset, band_height, full_height)
    if end == band_height:
        return rasterize_gbuf(binned, width, end, msaa=msaa, zbound=zbound)
    if zbound is not None:
        z = zbound[0]
        above = z.new_full((y_offset, width), 2.0)
        below = z.new_full((end - y_offset - band_height, width), 2.0)
        zbound = tuple(torch.cat([above, b, below]) for b in zbound)
    return tuple(t.narrow(t.ndim - 2, y_offset, band_height).contiguous()
                 for t in rasterize_gbuf(binned, width, end, msaa=msaa,
                                         zbound=zbound))


def killed_record(rows: int, device: torch.device) -> torch.Tensor:
    """A record whose coverage test never passes (e'0 = (0, 0, -1))."""
    k = torch.zeros(rows, dtype=torch.float32, device=device)
    k[2] = -1.0
    k[12] = float(BG_ID)
    return k


def pack_records(setup: TriangleSetup,
                 extra: torch.Tensor | None = None) -> torch.Tensor:
    """[T, R] records: e'0..2 (scale-folded, 9) | dp (3) | tri id |
    extra, padded to a multiple of 8 columns; invalid triangles become
    killed records."""
    t = setup.edges9.shape[0]
    dev = setup.edges9.device
    e9, zc, vs = setup.edges9, setup.zc, setup.vert_scale
    cols = [e9[:, 3 * k + j] * vs[:, k] for k in range(3) for j in range(3)]
    cols += [zc[:, 0] * e9[:, j] + zc[:, 1] * e9[:, 3 + j]
             + zc[:, 2] * e9[:, 6 + j] for j in range(3)]
    parts = [torch.stack(cols, dim=1),
             torch.arange(t, dtype=torch.float32, device=dev)[:, None]]
    if extra is not None:
        parts.append(extra.to(torch.float32))
    rec = torch.cat(parts, dim=1)
    rows = cdiv(rec.shape[1], 8) * 8
    if rows > rec.shape[1]:
        rec = torch.nn.functional.pad(rec, (0, rows - rec.shape[1]))
    return torch.where(setup.valid[:, None], rec, killed_record(rows, dev))


def _u32_as_f32(v: torch.Tensor) -> torch.Tensor:
    """int64 holding an unsigned 32-bit pattern -> the f32 with those
    bits."""
    v = torch.where(v >= 2 ** 31, v - 2 ** 32, v)
    return v.to(torch.int32).view(torch.float32)


def _bf16_bits(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 (nearest even) -> its 16 bits in an int64."""
    return x.to(torch.bfloat16).view(torch.int16).to(torch.int64) & 0xFFFF


def pack_bf16_pair(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Two f32 arrays -> one f32 whose top/bottom 16 bits are their bf16
    roundings (hi supplies the exponent)."""
    return _u32_as_f32((_bf16_bits(hi) << 16) | _bf16_bits(lo))


def pack_gbuf_extra_corners(corner_normals: torch.Tensor,
                            corner_tangents: torch.Tensor,
                            corner_uvs: torch.Tensor,
                            tri_item: torch.Tensor,
                            normal_mats: torch.Tensor,
                            tri_mid: torch.Tensor,
                            tri_obj: torch.Tensor) -> torch.Tensor:
    """Extra record columns of the G-buffer kernel, [T, 17]: per corner
    pack(nrm+3, tan) x3 and uv x2, then mid*65536+item and object id."""
    t = tri_item.shape[0]
    n = normal_mats.shape[0]
    item3 = tri_item.repeat_interleave(3)
    nm = palette_lookup(item3, normal_mats.reshape(n, 9).contiguous()
                        ).reshape(-1, 3, 3)
    wnrm = matvec_fma(nm, corner_normals)
    wtan = matvec_fma(nm, corner_tangents)
    packed_nt = pack_bf16_pair(wnrm + NRM_PACK_BIAS, wtan)
    va = torch.cat([packed_nt, corner_uvs], dim=1)
    mid_item = tri_mid.to(torch.float32) * 65536.0 + tri_item.to(torch.float32)
    return torch.cat([va.reshape(t, 3 * GBUF_VATTR), mid_item[:, None],
                      tri_obj.to(torch.float32)[:, None]], dim=1)


# ===========================================================================
# 3. binning
# ===========================================================================

@dataclass(frozen=True)
class BinnedTriangles:
    pairs: torch.Tensor     # [cap, R] records sorted by bin (pair-major);
    #                         tile bins first, then tile-row bins
    starts: torch.Tensor    # [NT + 1] int32 tile-segment offsets
    rstarts: torch.Tensor   # [TILES_Y + 1] int32 row-segment offsets
    gpairs: torch.Tensor    # [GLOBAL_CAP, R] global-tier records
    gmeta: torch.Tensor     # [2] int32: (gcount, tiles_x)
    overflow: torch.Tensor  # [3] int32: (pairs, row pairs, globals dropped)
    demand: torch.Tensor    # int32 pair demand of the frame
    tiles_x: int = 0
    tiles_y: int = 0
    pair_cap: int = 0


def _pair_counts(setup: TriangleSetup, k_max: int):
    """The tiering rule -> (pairs per triangle [T], row-tier mask [T],
    tile span width [T]): a triangle covering at most k_max tiles emits
    one pair per tile, a larger one one pair per tile row."""
    span_w = setup.tile_hi[:, 0].long() - setup.tile_lo[:, 0].long() + 1
    span_h = setup.tile_hi[:, 1].long() - setup.tile_lo[:, 1].long() + 1
    ncover = span_w * span_h
    live = setup.valid & ~setup.big
    medium = live & (ncover > k_max)
    nc = torch.where(live & (ncover <= k_max), ncover,
                     torch.where(medium, span_h, torch.zeros_like(span_h)))
    return nc, medium, span_w


def bin_triangles(setup: TriangleSetup, width: int, height: int,
                  k_max: int = K_MAX_DEFAULT,
                  pair_capacity: int | None = None,
                  extra: torch.Tensor | None = None) -> BinnedTriangles:
    """Tile binning. The reference sorts with one-hot radix passes (a TPU
    scatter workaround); here a stable sort on the bin gives the same
    order: pairs enumerate triangles in id order and each triangle's
    covered tiles in row-major order, and the sort keeps that order inside
    each bin. Bins 0..NT-1 are tiles (small triangles), NT..NT+TILES_Y-1
    tile rows (triangles covering more than k_max tiles)."""
    tiles_x = cdiv(width, TILE_W)
    tiles_y = cdiv(height, TILE_H)
    nt = tiles_x * tiles_y
    nbins = nt + tiles_y
    t = setup.edges9.shape[0]
    dev = setup.edges9.device
    if pair_capacity is None:
        pair_capacity = default_pair_cap(t)
    cap_all = cdiv(pair_capacity, GROUP) * GROUP

    records = pack_records(setup, extra)
    rows = records.shape[1]
    killed = killed_record(rows, dev)

    tx0 = setup.tile_lo[:, 0].long()
    ty0 = setup.tile_lo[:, 1].long()
    nc, medium, span_w = _pair_counts(setup, k_max)
    big = setup.valid & setup.big

    total = int(nc.sum())
    n_live = min(total, cap_all)
    tri_of_pair = torch.repeat_interleave(
        torch.arange(t, device=dev), nc, output_size=total)[:n_live]
    offs = torch.cumsum(nc, 0) - nc
    k = torch.arange(n_live, device=dev) - offs[tri_of_pair]
    sw = span_w[tri_of_pair].clamp(min=1)
    q = torch.div(k, sw, rounding_mode="floor")
    fine = (ty0[tri_of_pair] + q) * tiles_x + tx0[tri_of_pair] + (k - q * sw)
    row = nt + ty0[tri_of_pair] + k
    bins = torch.where(medium[tri_of_pair], row, fine)
    _, order = torch.sort(bins, stable=True)
    pairs = torch.cat([records[tri_of_pair[order]],
                       killed.expand(cap_all - n_live, rows)], dim=0)
    counts = torch.bincount(bins, minlength=nbins)
    starts_all = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                            torch.cumsum(counts, 0)]).to(torch.int32)
    dropped = max(total - cap_all, 0)

    # global tier: its ids in ascending order, truncated at GLOBAL_CAP
    gids = torch.nonzero(big).flatten()[:GLOBAL_CAP]
    gcount = gids.shape[0]
    gpairs = killed.expand(GLOBAL_CAP, rows).clone()
    gpairs[:gcount] = records[gids]
    nbig = int(big.sum())

    i32 = dict(dtype=torch.int32, device=dev)
    return BinnedTriangles(
        pairs=pairs, starts=starts_all[:nt + 1].contiguous(),
        rstarts=starts_all[nt:].contiguous(), gpairs=gpairs,
        gmeta=torch.tensor([gcount, tiles_x], **i32),
        overflow=torch.tensor([dropped, 0, max(nbig - GLOBAL_CAP, 0)], **i32),
        demand=torch.tensor(total, **i32),
        tiles_x=tiles_x, tiles_y=tiles_y, pair_cap=cap_all)


def pair_demand_of(setup: TriangleSetup,
                   k_max: int = K_MAX_DEFAULT) -> torch.Tensor:
    """The pair count bin_triangles will emit for this setup."""
    return _pair_counts(setup, k_max)[0].sum().to(torch.int32)


def pair_cap_bucket(demand: int, t: int | None = None) -> int:
    """Demand-sized pair capacity: the smallest bucket >= 1.5x demand on
    the {2^k, 1.5 * 2^k} ladder (64k floor), clamped at the safe default
    cap (reference: raster.pair_cap_bucket)."""
    need = max(65536, (3 * int(demand) + 1) // 2)
    bucket = GROUP
    while bucket < need:
        bucket *= 2
    if bucket // 2 * 3 // 2 >= need and bucket // 2 >= GROUP:
        bucket = bucket // 2 * 3 // 2
    if t is not None:
        bucket = min(bucket, default_pair_cap(t))
    return bucket


def default_pair_cap(t: int) -> int:
    """The safe T-sized cap bin_triangles picks with pair_capacity=None."""
    safe = (max(GROUP, min(int(t), 4 * 1024 * 1024))
            + max(8192, int(t) // 4))
    return cdiv(safe, GROUP) * GROUP


# ===========================================================================
# 4. the G-buffer raster (kernel K1)
# ===========================================================================

def _group_sequences(binned: BinnedTriangles) -> tuple[torch.Tensor, int]:
    """Per tile, the groups it streams, as indices into the groups of
    cat([gpairs, pairs]) -> ([NT, S] int64 with -1 past the end, S)."""
    dev = binned.pairs.device
    tiles_x, tiles_y = binned.tiles_x, binned.tiles_y
    nt = tiles_x * tiles_y
    ng_glob = binned.gpairs.shape[0] // GROUP
    n_glob = cdiv(int(binned.gmeta[0]), GROUP)
    starts = binned.starts.long()
    rstarts = binned.rstarts.long()
    ty = torch.arange(nt, device=dev) // tiles_x
    r0 = rstarts[ty] // GROUP
    n_row = -(-rstarts[ty + 1] // GROUP) - r0
    f0 = starts[:nt] // GROUP
    n_fine = -(-starts[1:] // GROUP) - f0
    total = n_glob + n_row + n_fine
    s_max = int(total.max()) if nt else 0
    s = torch.arange(s_max, device=dev)[None, :]
    n_row, r0, f0, total = (v[:, None] for v in (n_row, r0, f0, total))
    seq = torch.where(
        s < n_glob, s,
        torch.where(s < n_glob + n_row, ng_glob + r0 + (s - n_glob),
                    ng_glob + f0 + (s - n_glob - n_row)))
    return torch.where(s < total, seq, torch.full_like(seq, -1)), s_max


def plane_consts(rec: torch.Tensor, x0: torch.Tensor,
                 y0: torch.Tensor) -> list:
    """Per plane of records rec [..., >=12] at tile origins x0/y0
    (broadcastable against rec[..., 0]), the tile-local constants of the
    split evaluation before the split: (ex/2, ey/2, fma(ey, y0, fma(ex, x0,
    ew)) [+ the 2^-15 edge bias for the three edges]), f32."""
    out = []
    for p in range(4):
        ex, ey, ew = rec[..., 3 * p], rec[..., 3 * p + 1], rec[..., 3 * p + 2]
        ex2 = ex * 0.5
        ey2 = ey * 0.5
        # XLA contracts the reference's ew + ex*x0 + ey*y0 into two
        # fused multiply-adds on the CPU (tile origins past 128 make
        # the products inexact)
        ew2 = _fma(ey, y0, _fma(ex, x0, ew))
        if p < 3:
            ew2 = ew2 + ((ex2.abs() * (2.0 * TILE_W) + ey2.abs() * (2.0 * TILE_H)
                          + ew2.abs()) * EDGE_BIAS)
        out.append((ex2, ey2, ew2))
    return out


def _plane_eval_split(rec: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor,
                      xs: torch.Tensor, ys: torch.Tensor) -> list:
    """The reference's split-eval plane evaluation (_plane_eval_dots):
    rec [C, G, >=12] records, x0/y0 [C] tile origins, xs [NX] / ys [TILE_H]
    the bf16-exact local coordinates X = 2*lx+1 / Y = 2*ly+1 of the
    evaluated columns / rows -> [b0, b1, b2, z], each [C, G, TILE_H * NX]
    (row-major pixels). Per plane: b = ((hx*X + hy*Y) + hw) +
    ((lx*X + ly*Y) + lw), where (h, l) are the bf16 hi/lo parts of (ex/2,
    ey/2, fma(ey, y0, fma(ex, x0, ew)) [+ the 2^-15 edge bias]); every
    product against X and Y is exact in f32, so only this order of
    additions decides the rounding."""
    out = []
    c, g = rec.shape[:2]
    for ex2, ey2, ew2 in plane_consts(rec, x0[:, None], y0[:, None]):
        parts = []
        for v in (ex2, ey2, ew2):
            h = v.to(torch.bfloat16).to(torch.float32)
            parts.append((h, (v - h).to(torch.bfloat16).to(torch.float32)))
        (hx, lx), (hy, ly), (hw, lw) = parts
        # the X and Y products are exact, so forming them per column and
        # per row and adding them per pixel rounds as the reference does
        hi = ((hx[..., None, None] * xs) + (hy[..., None, None] * ys[:, None])
              + hw[..., None, None])
        lo = ((lx[..., None, None] * xs) + (ly[..., None, None] * ys[:, None])
              + lw[..., None, None])
        out.append((hi + lo).reshape(c, g, -1))
    return out


def _unpack_attrs(a: torch.Tensor) -> torch.Tensor:
    """A corner's record columns [..., 5] (three bf16 (normal + 3, tangent)
    words, u, v) -> [..., 8] normal, tangent, uv."""
    pw = a[..., 0:3].contiguous().view(torch.int32).to(torch.int64)
    nrm = _u32_as_f32(pw & 0xFFFF0000) - NRM_PACK_BIAS
    tan = _u32_as_f32((pw & 0xFFFF) << 16)
    return torch.cat([nrm, tan, a[..., 3:5]], dim=-1)


def _resolve(rows: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
             is_bg: torch.Tensor) -> torch.Tensor:
    """The reference kernel's per-pixel resolve: rows [..., 30] winner
    records, px/py pixel centers -> gbuf [..., GBUF_OUT].

    The reference, run on the CPU, contracts two of its multiply-adds
    into FMAs (b = fma(ex, px, ey*py) + ew and the last term of the
    attribute blend); the barycentrics cancel heavily near edges, so the
    port rounds the same way (_fma) to stay within 1e-6 of it."""
    zero = torch.zeros((), dtype=torch.float32, device=rows.device)
    ls = []
    for i in range(3):
        b = _fma(rows[..., 3 * i], px, rows[..., 3 * i + 1] * py) + rows[..., 3 * i + 2]
        ls.append(torch.where(b < 0, zero, b))
    lsum = ls[0] + ls[1] + ls[2]
    lsum = torch.where(lsum < 1e-30, torch.full_like(lsum, 1e-30), lsum)
    ls = [v / lsum for v in ls]

    a = [_unpack_attrs(rows[..., 13 + 5 * v:18 + 5 * v]) for v in range(3)]
    interp = _fma(a[2], ls[2][..., None],
                  a[0] * ls[0][..., None] + a[1] * ls[1][..., None])
    mi = rows[..., 28].to(torch.int32)
    misc = torch.stack([(mi >> 16).to(torch.float32), rows[..., 29],
                        (mi & 0xFFFF).to(torch.float32)], dim=-1)
    pad = torch.zeros((*interp.shape[:-1], GBUF_OUT - 11),
                      dtype=torch.float32, device=rows.device)
    g = torch.cat([interp, misc, pad], dim=-1)
    return torch.where(is_bg[..., None], zero, g)


CENTER, COVERAGE, SAMPLES4 = "center", "coverage", "samples4"


def _group_keys(mode: str, rec: torch.Tensor, b0, b1, b2, z, live, cov,
                window=None):
    """One streamed group's depth keys, [C, G, NPX] per carry, in the
    reference kernels' arithmetic; records that do not compete get a key
    at or above the carry's clear value. rec [C, G, 12] the group's plane
    rows, live [C] whether the tile streams this group (a padding entry of
    _group_sequences does not). window (K1-bounded): (zlo, zhi), each
    [C, 1, NPX]; a fragment competes only where zlo < z < zhi (strict, the
    pixel-center z).
    - CENTER (K1, K2): key z where b0, b1, b2, z >= 0 (and inside the
      window), else 2.
    - COVERAGE (K1-MSAA): per-sample thresholds t_i = -(e_ix dx + e_iy dy)
      from the unsplit rows, a sample covered where b_i(center) >= t_i and
      0 <= z <= 1 (and inside the window); key z where the center is
      covered, z + 1 where only a sample is, else 4; cov [C, 4, NPX]
      takes each sample's coverage by any record of the group (sticky).
      The thresholds round as
      MSAA_COVERAGE_FUSED for the coverage bits and MSAA_KEY_FUSED for
      the key's "some sample covered".
    - SAMPLES4 (K2-msaa4): per sample, b_i + (e_ix dx + e_iy dy) added to
      the split values, covered where all four are >= 0; key z_s, else 2.
      One key per sample."""
    two = torch.tensor(2.0, device=z.device)
    if mode == CENTER:
        cover = torch.minimum(torch.minimum(b0, b1), torch.minimum(b2, z)) >= 0
        if window is not None:
            cover = cover & (z > window[0]) & (z < window[1])
        return [torch.where(cover, z, two)]
    planes = (b0, b1, b2, z)
    if mode == COVERAGE:
        zok = (z >= 0) & (z <= 1)
        if window is not None:
            zok = zok & (z > window[0]) & (z < window[1])
        cover_any = torch.zeros_like(zok)
        for s in range(len(MSAA4_OFFSETS)):
            c = k = zok
            for i in range(3):
                a, b = rec[..., 3 * i], rec[..., 3 * i + 1]
                t = msaa_threshold(a, b, s, MSAA_COVERAGE_FUSED[s][i])
                c = c & (planes[i] >= t[..., None])
                if MSAA_KEY_FUSED[s][i] != MSAA_COVERAGE_FUSED[s][i]:
                    t = msaa_threshold(a, b, s, MSAA_KEY_FUSED[s][i])
                k = k & (planes[i] >= t[..., None])
            cover_any = cover_any | k
            cov[:, s] |= c.any(dim=1) & live[:, None]
        cover_c = (b0 >= 0) & (b1 >= 0) & (b2 >= 0) & zok
        return [torch.where(cover_c, z, torch.where(
            cover_any, z + 1.0, torch.tensor(MSAA_KEY_CLEAR, device=z.device)))]
    keys = []
    for dx, dy in MSAA4_OFFSETS:
        bs = [planes[i] + sample_offset(rec[..., 3 * i], rec[..., 3 * i + 1],
                                        dx, dy)[..., None] for i in range(4)]
        cover = torch.minimum(torch.minimum(bs[0], bs[1]),
                              torch.minimum(bs[2], bs[3])) >= 0
        keys.append(torch.where(cover, bs[3], two))
    return keys


def _stream_chunks(binned: BinnedTriangles, allrec: torch.Tensor, width: int,
                   mode: str = CENTER, zbound: torch.Tensor | None = None):
    """The tile stream of the raster kernels, in plain PyTorch: all tiles
    of a chunk step through their group streams together; a group's
    winner is its first minimum key (_group_keys) and replaces the carry
    only if strictly nearer, as in the reference kernels. allrec is
    cat([gpairs, pairs]). Yields per chunk (tiles [C], x0 [C], y0 [C],
    depth [C, K, NPX], win [C, K, NPX] int64: the winner's row in allrec,
    -1 = none; cov [C, 4, NPX] bool or None), K carries: 4 in SAMPLES4
    mode, else 1. depth is the carry: the depth key in COVERAGE mode
    (cleared to 4), else the depth (cleared to 1). A frame narrower than
    one tile evaluates only its own columns (the others are cropped away:
    depth at its clear value, win -1, no coverage). zbound [NT, 2, NPX]
    (tile_image of zlo and zhi) bounds K1's fragments to a window."""
    dev = allrec.device
    nt = binned.tiles_x * binned.tiles_y
    nx = min(TILE_W, width) if binned.tiles_x == 1 else TILE_W
    nk = 4 if mode == SAMPLES4 else 1
    clear = MSAA_KEY_CLEAR if mode == COVERAGE else 1.0
    # tiles stepped together; each plane temporary is [chunk, GROUP, NPX]
    # f32, 1 MiB per tile, so the CPU steps fewer at a time
    chunk = 64 if dev.type == "cuda" else 16
    groups = allrec.view(-1, GROUP, allrec.shape[1])
    seq, s_max = _group_sequences(binned)
    xs = 2.0 * torch.arange(nx, device=dev, dtype=torch.float32) + 1.0
    ys = 2.0 * torch.arange(TILE_H, device=dev, dtype=torch.float32) + 1.0
    sub = torch.arange(GROUP, device=dev)[None, :, None]
    for c0 in range(0, nt, chunk):
        tiles = torch.arange(c0, min(c0 + chunk, nt), device=dev)
        x0 = ((tiles % binned.tiles_x) * TILE_W).to(torch.float32)
        y0 = ((tiles // binned.tiles_x) * TILE_H).to(torch.float32)
        npx = TILE_H * nx
        depth = torch.full((len(tiles), nk, npx), clear, dtype=torch.float32,
                           device=dev)
        win = torch.full((len(tiles), nk, npx), -1, dtype=torch.int64, device=dev)
        cov = (torch.zeros((len(tiles), 4, npx), dtype=torch.bool, device=dev)
               if mode == COVERAGE else None)
        window = None
        if zbound is not None:
            zb = zbound[tiles].view(len(tiles), 2, TILE_H, TILE_W)[..., :nx]
            zb = zb.reshape(len(tiles), 2, npx)
            window = (zb[:, 0:1], zb[:, 1:2])
        for s in range(s_max):
            g = seq[tiles, s]
            live = g >= 0
            rec = groups[g.clamp(min=0), :, :12]
            b0, b1, b2, z = _plane_eval_split(rec, x0, y0, xs, ys)
            keys = _group_keys(mode, rec, b0, b1, b2, z, live, cov, window)
            for k, zm in enumerate(keys):
                zmin = zm.min(dim=1).values
                amin = torch.where(zm == zmin[:, None], sub, GROUP).min(dim=1).values
                upd = live[:, None] & (zmin < depth[:, k])
                depth[:, k] = torch.where(upd, zmin, depth[:, k])
                win[:, k] = torch.where(upd, g[:, None] * GROUP + amin, win[:, k])
        if nx < TILE_W:
            def widen(a, fill):
                full = torch.full((*a.shape[:2], TILE_H, TILE_W), fill,
                                  dtype=a.dtype, device=dev)
                full[..., :nx] = a.view(*a.shape[:2], TILE_H, nx)
                return full.view(*a.shape[:2], NPX)
            depth, win = widen(depth, clear), widen(win, -1)
            cov = None if cov is None else widen(cov, False)
        yield tiles, x0, y0, depth, win, cov


def _untile(a: torch.Tensor, binned: BinnedTriangles, width: int,
            height: int) -> torch.Tensor:
    """[NT, NPX, ...] tile-major -> [H, W, ...] image."""
    tiles_x, tiles_y = binned.tiles_x, binned.tiles_y
    rest = a.shape[2:]
    img = a.reshape(tiles_y, tiles_x, TILE_H, TILE_W, *rest)
    img = img.transpose(1, 2).reshape(tiles_y * TILE_H, tiles_x * TILE_W, *rest)
    return img[:height, :width]


def _winner_ids(allrec: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """The winner's record row 12 as int32, BG_ID where nothing won."""
    return torch.where(win < 0, BG_ID, allrec[win.clamp(min=0), 12].to(torch.int32))


def unbias_msaa_key(key: torch.Tensor) -> torch.Tensor:
    """K1-MSAA's depth key -> depth: [0, 1) center-covered stays, [1, 3)
    sample-only drops the + 1, the clear value 4 becomes 1 (background).
    A center-covered fragment at exactly z = 1 (key 1.0) so becomes depth
    0, as in the reference."""
    return torch.where(key < 1.0, key,
                       torch.where(key < 3.0, key - 1.0, torch.ones_like(key)))


def tile_image(img: torch.Tensor, tiles_x: int, tiles_y: int) -> torch.Tensor:
    """[H, W] image -> [NT, NPX] tile-major layout (the inverse of _untile),
    edge-padded to whole tiles as the reference pads it."""
    h, w = img.shape
    dev = img.device
    rows = torch.arange(tiles_y * TILE_H, device=dev).clamp(max=h - 1)
    cols = torch.arange(tiles_x * TILE_W, device=dev).clamp(max=w - 1)
    img = img[rows][:, cols].reshape(tiles_y, TILE_H, tiles_x, TILE_W)
    return img.transpose(1, 2).reshape(tiles_y * tiles_x, NPX)


def gbuf_kernel_name(msaa: bool, bounded: bool) -> str:
    """The launch name of a K1 variant (_backend.KERNELS)."""
    return ("raster_gbuf" + ("_msaa" if msaa else "")
            + ("_bounded" if bounded else ""))


def rasterize_gbuf_plain(binned: BinnedTriangles, width: int, height: int,
                         msaa: bool = False, zbound=None):
    """Plain PyTorch version of kernel K1: the shared tile stream, then the
    winner's resolve at the pixel center. -> (depth [H, W], tri_id [H, W]
    int32, gbuf [GBUF_OUT, H, W]) and with msaa the per-sample sticky
    coverage [4, H, W] f32 in {0, 1} (MSAA4_OFFSETS). zbound = (zlo, zhi),
    each [H, W]: only fragments with zlo < z < zhi compete."""
    _backend.count_plain(gbuf_kernel_name(msaa, zbound is not None),
                         binned.pairs)
    dev = binned.pairs.device
    nt = binned.tiles_x * binned.tiles_y
    allrec = torch.cat([binned.gpairs, binned.pairs], dim=0)
    lin = torch.arange(NPX, device=dev)
    lxf = (lin % TILE_W).to(torch.float32)
    lyf = (lin // TILE_W).to(torch.float32)
    depth_t = torch.empty((nt, NPX), dtype=torch.float32, device=dev)
    id_t = torch.empty((nt, NPX), dtype=torch.int32, device=dev)
    gbuf_t = torch.empty((nt, NPX, GBUF_OUT), dtype=torch.float32, device=dev)
    cov_t = (torch.empty((nt, NPX, 4), dtype=torch.float32, device=dev)
             if msaa else None)
    mode = COVERAGE if msaa else CENTER
    zb = None
    if zbound is not None:
        zb = torch.stack([tile_image(z, binned.tiles_x, binned.tiles_y)
                          for z in zbound], dim=1)
    for tiles, x0, y0, depth, win, cov in _stream_chunks(binned, allrec, width,
                                                         mode, zb):
        depth, win = depth[:, 0], win[:, 0]
        rows = allrec[win.clamp(min=0), :SEL_ROWS]
        px = (lxf + x0[:, None]) + 0.5
        py = (lyf + y0[:, None]) + 0.5
        depth_t[tiles] = unbias_msaa_key(depth) if msaa else depth
        id_t[tiles] = _winner_ids(allrec, win)
        gbuf_t[tiles] = _resolve(rows, px, py, win < 0)
        if msaa:
            cov_t[tiles] = cov.transpose(1, 2).to(torch.float32)
    gbuf = _untile(gbuf_t, binned, width, height).permute(2, 0, 1).contiguous()
    out = (_untile(depth_t, binned, width, height).contiguous(),
           _untile(id_t, binned, width, height).contiguous(), gbuf)
    if msaa:
        cov = _untile(cov_t, binned, width, height).permute(2, 0, 1).contiguous()
        return out + (cov,)
    return out


def _check_binned(name: str, binned: BinnedTriangles, rows: int, width: int,
                  height: int) -> None:
    """Validate a BinnedTriangles handed to a CUDA raster kernel."""
    dev = binned.pairs.device
    f32, i32 = torch.float32, torch.int32
    _backend.require(binned.pairs, "pairs", f32, dev, ndim=2)
    _backend.require(binned.gpairs, "gpairs", f32, dev, ndim=2)
    _backend.require(binned.starts, "starts", i32, dev, ndim=1)
    _backend.require(binned.rstarts, "rstarts", i32, dev, ndim=1)
    _backend.require(binned.gmeta, "gmeta", i32, dev, ndim=1)
    if (binned.pairs.shape[1] != rows or binned.gpairs.shape[1] != rows
            or binned.pairs.shape[0] % GROUP or binned.gpairs.shape[0] % GROUP):
        raise ValueError(f"{name}: records must be [k*128, {rows}]")
    if (binned.starts.shape[0] != binned.tiles_x * binned.tiles_y + 1
            or binned.rstarts.shape[0] != binned.tiles_y + 1
            or binned.gmeta.shape[0] != 2):
        raise ValueError(f"{name}: segment tables do not match tiles")
    if (cdiv(width, TILE_W) != binned.tiles_x
            or cdiv(height, TILE_H) != binned.tiles_y):
        raise ValueError(f"{name}: frame size does not match tiles")


def _binned_args(binned: BinnedTriangles, width: int, height: int) -> tuple:
    return (binned.pairs.data_ptr(), binned.gpairs.data_ptr(),
            binned.starts.data_ptr(), binned.rstarts.data_ptr(),
            binned.gmeta.data_ptr(), binned.tiles_x, binned.tiles_y, width,
            height)


def _check_zbound(zbound, binned: BinnedTriangles, width: int,
                  height: int) -> None:
    """Validate the depth window handed to K1: (zlo, zhi), each a
    contiguous [H, W] f32 tensor on the records' device."""
    if not (isinstance(zbound, (tuple, list)) and len(zbound) == 2):
        raise ValueError("rasterize_gbuf: zbound must be (zlo, zhi)")
    dev = binned.pairs.device
    for name, z in zip(("zlo", "zhi"), zbound):
        _backend.require(z, name, torch.float32, dev, ndim=2)
        if tuple(z.shape) != (height, width):
            raise ValueError(f"rasterize_gbuf: {name} is {tuple(z.shape)}, "
                             f"expected {(height, width)}")


def rasterize_gbuf(binned: BinnedTriangles, width: int, height: int,
                   msaa: bool = False, zbound=None):
    """G-buffer rasterization -> (depth [H, W], tri_id [H, W] int32,
    gbuf [GBUF_OUT, H, W]) with channels 0-2 world normal, 3-5 world
    tangent, 6-7 uv, 8 material id, 9 object id, 10 item id. Background
    pixels: depth 1, tri_id -1, gbuf 0. With msaa a 4th output, the
    per-sample coverage [4, H, W] in {0, 1} (MSAA4_OFFSETS; its mean over
    axis 0 is the silhouette blend weight), and the winner is the nearest
    triangle covering the center, else the nearest covering any sample.
    zbound = (zlo [H, W], zhi [H, W]) f32 on the records' device: only
    fragments in the open window zlo < z < zhi (the pixel-center z)
    compete, in both sample modes (the depth-peeling primitive of the
    transparent pass and the alpha-mask peel)."""
    if zbound is not None:
        _check_zbound(zbound, binned, width, height)
    return rasterize_gbuf_plain(binned, width, height, msaa, zbound)


# ===========================================================================
# 4b. where a record can reach: the reject stream's tests, and the work
#     the raster kernels need
# ===========================================================================

FOOT_W, FOOT_H = 32, 8      # a warp's pixels (raster_common.cuh)
BLOCK_W, BLOCK_H = 8, 4     # covered_block_pairs' pixel block
REJECT_REL = 2.0 ** -15     # the reject margin per unit of sum |terms|
REJECT_ABS = 2.0 ** -100    # its floor
REJECT_THR = 1.0 + 2.0 ** -20
BATCH = 256                 # records per batch of the reject stream
CHUNK = 32                  # survivors a warp tests at a time


def _block_bounds(cols: tuple, rows: tuple) -> tuple:
    """Tile-local pixel-centre coordinates X = 2 lx + 1 of the first and
    last column and row."""
    return (2.0 * cols[0] + 1.0, 2.0 * cols[1] + 1.0,
            2.0 * rows[0] + 1.0, 2.0 * rows[1] + 1.0)


def _margin(a, b, c, x_hi, y_hi):
    return ((a.abs() * x_hi + b.abs() * y_hi) + c.abs()) * REJECT_REL + REJECT_ABS


def reject_block(rec: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor,
                 cols: tuple, rows: tuple, mode: str) -> torch.Tensor:
    """The reject stream's test (raster_common.cuh reject_record, whose
    header derives the margin): True where the record rec [..., >=12] of
    the tile at x0/y0 (broadcastable against rec[..., 0]) can change
    nothing on the tile-local pixel columns cols = (first, last) and rows =
    (first, last) in the sample mode's own test, any depth window ignored.
    Each plane's real value over the block is largest and smallest at a
    corner; reject where an edge's maximum plus the margin lies below the
    smallest value the mode accepts (0, or for COVERAGE and SAMPLES4 a
    lower bound of every sample threshold), or the depth plane's range plus
    the margin misses [0, inf) (CENTER), [0, 1] (COVERAGE) or, at every
    sample, [0, inf) (SAMPLES4). In f64, operation for operation as the
    kernel evaluates it."""
    if mode not in (CENTER, COVERAGE, SAMPLES4):
        raise ValueError(f"reject_block: unknown mode {mode}")
    x_lo, x_hi, y_lo, y_hi = _block_bounds(cols, rows)
    rej = None
    for p, planes in enumerate(plane_consts(rec, x0, y0)):
        a, b, c = (v.double() for v in planes)
        aa, ab = a.abs(), b.abs()
        vmax = (a * torch.where(a >= 0, x_hi, x_lo)
                + b * torch.where(b >= 0, y_hi, y_lo)) + c
        m = _margin(a, b, c, x_hi, y_hi)
        top = vmax + m
        thr = (0.0 if mode == CENTER
               else -(((aa + ab) * 0.75) * REJECT_THR))
        if p < 3 or mode == SAMPLES4:
            r = top < thr
        else:
            r = top < 0.0
            if mode == COVERAGE:
                vmin = (a * torch.where(a >= 0, x_lo, x_hi)
                        + b * torch.where(b >= 0, y_lo, y_hi)) + c
                r = r | ((vmin - m) > 1.0)
        rej = r if rej is None else rej | r
    return rej


def depth_floor_block(rec: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor,
                      cols: tuple, rows: tuple) -> torch.Tensor:
    """The occlusion reject's floor (raster_common.cuh depth_floor): the
    depth plane's smallest real value over the block's pixel centres, less
    the margin, f64; every pixel's computed z there lies above it."""
    x_lo, x_hi, y_lo, y_hi = _block_bounds(cols, rows)
    a, b, c = (v.double() for v in plane_consts(rec, x0, y0)[3])
    vmin = (a * torch.where(a >= 0, x_lo, x_hi)
            + b * torch.where(b >= 0, y_lo, y_hi)) + c
    return vmin - _margin(a, b, c, x_hi, y_hi)


def depth_reject_block(rec: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor,
                       cols: tuple, rows: tuple,
                       carry: torch.Tensor) -> torch.Tensor:
    """K2's occlusion reject (center mode): True where the record cannot
    pass the strict z < depth anywhere in the block whose largest current
    depth carry is `carry` (broadcastable): its floor is at or above it."""
    return depth_floor_block(rec, x0, y0, cols, rows) >= carry.double()


def record_covers(mode: str, rec: torch.Tensor, b0, b1, b2, z) -> torch.Tensor:
    """Whether each record changes anything at each pixel in the sample
    mode's own test, any depth window ignored: rec [C, G, 12], planes
    [C, G, NPX] (_plane_eval_split) -> [C, G, NPX] bool. CENTER: b0, b1,
    b2, z >= 0. COVERAGE: 0 <= z <= 1 and the center or some sample
    covered, under the coverage bits' or the key's rounding of its
    thresholds. SAMPLES4: some sample covered."""
    planes = (b0, b1, b2, z)
    if mode == CENTER:
        return torch.minimum(torch.minimum(b0, b1), torch.minimum(b2, z)) >= 0
    hit = torch.zeros_like(z, dtype=torch.bool)
    for s, (dx, dy) in enumerate(MSAA4_OFFSETS):
        if mode == COVERAGE:
            for fused in (MSAA_COVERAGE_FUSED[s], MSAA_KEY_FUSED[s]):
                c = torch.ones_like(hit)
                for i in range(3):
                    t = msaa_threshold(rec[..., 3 * i], rec[..., 3 * i + 1], s,
                                       fused[i])
                    c = c & (planes[i] >= t[..., None])
                hit = hit | c
        else:
            c = torch.ones_like(hit)
            for i in range(4):
                off = sample_offset(rec[..., 3 * i], rec[..., 3 * i + 1], dx, dy)
                c = c & ((planes[i] + off[..., None]) >= 0)
            hit = hit | c
    if mode == COVERAGE:
        hit = (hit | ((b0 >= 0) & (b1 >= 0) & (b2 >= 0))) & (z >= 0) & (z <= 1)
    return hit


def streamed_groups(binned: BinnedTriangles):
    """The raster kernels' tile streams: per chunk of tiles and step of
    _group_sequences -> (x0 [C], y0 [C], rec [C, GROUP, 12] the plane rows
    of the group each tile streams at that step, live [C]: whether it
    streams one)."""
    dev = binned.pairs.device
    nt = binned.tiles_x * binned.tiles_y
    groups = torch.cat([binned.gpairs[:, :12], binned.pairs[:, :12]]
                       ).view(-1, GROUP, 12)
    seq, s_max = _group_sequences(binned)
    chunk = 64 if dev.type == "cuda" else 16
    for c0 in range(0, nt, chunk):
        tiles = torch.arange(c0, min(c0 + chunk, nt), device=dev)
        x0 = ((tiles % binned.tiles_x) * TILE_W).to(torch.float32)
        y0 = ((tiles // binned.tiles_x) * TILE_H).to(torch.float32)
        for s in range(s_max):
            g = seq[tiles, s]
            yield x0, y0, groups[g.clamp(min=0)], g >= 0


def covered_block_pairs(binned: BinnedTriangles, width: int, height: int,
                        mode: str) -> int:
    """The (streamed record, BLOCK_W x BLOCK_H pixel block) pairs of a
    raster call in which the record covers at least one pixel centre or
    sample of the block inside the frame (record_covers, the plain split
    evaluation, any window ignored): the evaluation these inputs need, and
    the raster kernels' bound. A record streamed twice by a tile counts
    twice, as it is evaluated twice."""
    dev = binned.pairs.device
    lin = torch.arange(NPX, device=dev)
    xs = 2.0 * torch.arange(TILE_W, device=dev, dtype=torch.float32) + 1.0
    ys = 2.0 * torch.arange(TILE_H, device=dev, dtype=torch.float32) + 1.0
    total = 0
    for x0, y0, rec, live in streamed_groups(binned):
        cov = record_covers(mode, rec, *_plane_eval_split(rec, x0, y0, xs, ys))
        inside = (((x0[:, None] + (lin % TILE_W)) < width)
                  & ((y0[:, None] + (lin // TILE_W)) < height) & live[:, None])
        cov = (cov & inside[:, None, :]).view(
            *cov.shape[:2], TILE_H // BLOCK_H, BLOCK_H, TILE_W // BLOCK_W,
            BLOCK_W)
        total += int(cov.any(dim=5).any(dim=3).sum())
    return total


def won_block_pairs(tri_id: torch.Tensor) -> int:
    """The distinct (tri_id, BLOCK_W x BLOCK_H pixel block) pairs among the
    pixels a visibility output tri_id [H, W] gives a winner (>= 0): each
    winner is evaluated at least on a block it wins in. K2's bound since
    its occlusion reject, which skips covered but hidden pairs."""
    h, w = tri_id.shape
    dev = tri_id.device
    by = torch.arange(h, device=dev)[:, None] // BLOCK_H
    bx = torch.arange(w, device=dev)[None, :] // BLOCK_W
    block = (by * cdiv(w, BLOCK_W) + bx).expand(h, w)
    won = tri_id >= 0
    ids = tri_id[won].long()
    key = block[won] * (int(ids.max()) + 1 if ids.numel() else 1) + ids
    return int(torch.unique(key).numel())


def footprints() -> list:
    """The warp footprints: ((first, last) column, (first, last) row) of
    warp w = 0..7, as raster_common.cuh assigns its threads' pixels."""
    return [((c, c + FOOT_W - 1), (r, r + FOOT_H - 1))
            for r in range(0, TILE_H, FOOT_H) for c in range(0, TILE_W, FOOT_W)]


def reject_stream_counts(binned: BinnedTriangles, mode: str,
                         occlusion: bool = False) -> dict:
    """What the reject stream evaluates on these inputs, by the plain
    mirror of its tests (the kernels count nothing): "streamed" records
    (every record of every group the tiles stream), "tile_survivors"
    (those the tile-level test keeps, (a)) and "footprint_pairs" (the
    (survivor, warp footprint) pairs the per-warp footprint test keeps,
    (b)). With occlusion (K2's center mode) also "occluded": those of
    them that the occlusion reject drops, under the kernel's own depth
    carries: per tile, batches of BATCH records, each batch's survivors
    in stream order CHUNK at a time, each CHUNK tested against the
    footprint's largest carry before any of it is evaluated. Each kept
    pair costs the warp 256 pixel evaluations."""
    if occlusion and mode != CENTER:
        raise ValueError("the occlusion reject exists in CENTER mode only")
    dev = binned.pairs.device
    nt = binned.tiles_x * binned.tiles_y
    groups = torch.cat([binned.gpairs[:, :12], binned.pairs[:, :12]]
                       ).view(-1, GROUP, 12)
    seq, s_max = _group_sequences(binned)
    per = BATCH // GROUP
    nb = cdiv(s_max, per)
    seq = torch.nn.functional.pad(seq, (0, nb * per - s_max), value=-1)
    xs = 2.0 * torch.arange(TILE_W, device=dev, dtype=torch.float32) + 1.0
    ys = 2.0 * torch.arange(TILE_H, device=dev, dtype=torch.float32) + 1.0
    whole = ((0, TILE_W - 1), (0, TILE_H - 1))
    feet = footprints()
    out = {"streamed": 0, "tile_survivors": 0, "footprint_pairs": 0}
    if occlusion:
        out["occluded"] = 0
    chunk = 64 if dev.type == "cuda" else 16
    for c0 in range(0, nt, chunk):
        tiles = torch.arange(c0, min(c0 + chunk, nt), device=dev)
        nc = tiles.shape[0]
        x0 = ((tiles % binned.tiles_x) * TILE_W).to(torch.float32)[:, None]
        y0 = ((tiles // binned.tiles_x) * TILE_H).to(torch.float32)[:, None]
        carry = torch.ones((nc, NPX), device=dev)
        for b in range(nb):
            g = seq[tiles, b * per:(b + 1) * per]
            rec = groups[g.clamp(min=0)].reshape(nc, BATCH, 12)
            live = (g >= 0).repeat_interleave(GROUP, dim=1)
            kept = live & ~reject_block(rec, x0, y0, *whole, mode)
            out["streamed"] += int(live.sum())
            out["tile_survivors"] += int(kept.sum())
            if not occlusion:
                for cols, rows in feet:
                    out["footprint_pairs"] += int(
                        (kept & ~reject_block(rec, x0, y0, cols, rows, mode)).sum())
                continue
            # the survivors in stream order, CHUNK at a time
            order = torch.sort((~kept).to(torch.uint8), dim=1, stable=True).indices
            srec = rec.gather(1, order[..., None].expand(-1, -1, 12))
            skept = kept.gather(1, order)
            for q in range(cdiv(int(kept.sum(dim=1).max()), CHUNK)):
                r = srec[:, q * CHUNK:(q + 1) * CHUNK]
                k = skept[:, q * CHUNK:(q + 1) * CHUNK]
                far = carry.view(nc, TILE_H // FOOT_H, FOOT_H, TILE_W // FOOT_W,
                                 FOOT_W).amax(dim=(2, 4)).reshape(nc, -1)
                for f, (cols, rows) in enumerate(feet):
                    fk = k & ~reject_block(r, x0, y0, cols, rows, mode)
                    occ = fk & depth_reject_block(r, x0, y0, cols, rows,
                                                  far[:, f:f + 1])
                    out["footprint_pairs"] += int(fk.sum())
                    out["occluded"] += int(occ.sum())
                planes = _plane_eval_split(r, x0[:, 0], y0[:, 0], xs, ys)
                cov = record_covers(CENTER, r, *planes) & k[..., None]
                z = torch.where(cov, planes[3], torch.full_like(planes[3], 2.0))
                carry = torch.minimum(carry, z.amin(dim=1))
    return out


# ===========================================================================
# 5. the visibility raster (kernel K2)
# ===========================================================================

def rasterize_plain(binned: BinnedTriangles, width: int, height: int,
                    msaa: bool = False):
    """Plain PyTorch version of kernel K2: the shared tile stream. ->
    (depth [H, W], tri_id [H, W] int32) for the center sample, or with
    msaa per-sample stacks [4, H, W] each (MSAA4_OFFSETS)."""
    _backend.count_plain("raster_vis_msaa4" if msaa else "raster_vis",
                         binned.pairs)
    dev = binned.pairs.device
    nt = binned.tiles_x * binned.tiles_y
    nk = 4 if msaa else 1
    allrec = torch.cat([binned.gpairs, binned.pairs], dim=0)
    depth_t = torch.empty((nt, NPX, nk), dtype=torch.float32, device=dev)
    id_t = torch.empty((nt, NPX, nk), dtype=torch.int32, device=dev)
    for tiles, _, _, depth, win, _ in _stream_chunks(
            binned, allrec, width, SAMPLES4 if msaa else CENTER):
        depth_t[tiles] = depth.transpose(1, 2)
        id_t[tiles] = _winner_ids(allrec, win).transpose(1, 2)
    depth = _untile(depth_t, binned, width, height).permute(2, 0, 1)
    tri_id = _untile(id_t, binned, width, height).permute(2, 0, 1)
    if not msaa:
        depth, tri_id = depth[0], tri_id[0]
    return depth.contiguous(), tri_id.contiguous()


def rasterize(binned: BinnedTriangles, width: int, height: int,
              msaa: bool = False):
    """Visibility rasterization of 16-row records -> (depth [H, W] f32 in
    [0, 1], cleared 1.0; tri_id [H, W] int32, -1 = none) for the pixel
    center, or with msaa per-sample stacks [4, H, W] each (MSAA4_OFFSETS)."""
    return rasterize_plain(binned, width, height, msaa)


# ===========================================================================
# 6. record evaluation outside the kernels (the MSAA edge resolve)
# ===========================================================================

def eval_record_planes(rec: torch.Tensor, px: torch.Tensor, py: torch.Tensor):
    """A packed record's edge and depth planes at pixel coordinates:
    rec [..., >=12] (scaled edges 0-8, depth plane 9-11), px/py
    broadcastable -> (b0, b1, b2, z), each e_x*px + e_y*py + e_w with the
    products and sums rounded one by one, as the reference runs it op by
    op (no fused multiply-add)."""
    return tuple(rec[..., 3 * p] * px + rec[..., 3 * p + 1] * py + rec[..., 3 * p + 2]
                 for p in range(4))


def interp_record_attrs(rec: torch.Tensor, px: torch.Tensor,
                        py: torch.Tensor) -> dict:
    """The G-buffer kernel's resolve for a list of pixels, as the reference
    runs it op by op: rec [N, 32] records, px/py [N] pixel centers ->
    dict(depth [N] clipped to [0, 1], wnrm/wtan [N, 3], uv [N, 2],
    mat_id/object_id/item_id [N] int32)."""
    b0, b1, b2, z = eval_record_planes(rec, px, py)
    ls = [b.clamp(min=0.0) for b in (b0, b1, b2)]
    lsum = (ls[0] + ls[1] + ls[2]).clamp(min=1e-30)
    w = [(v / lsum)[:, None] for v in ls]
    a = [_unpack_attrs(rec[:, 13 + 5 * v:18 + 5 * v]) for v in range(3)]
    interp = a[0] * w[0] + a[1] * w[1] + a[2] * w[2]
    mi = rec[:, 28].to(torch.int32)
    return {"depth": z.clamp(0.0, 1.0), "wnrm": interp[:, 0:3],
            "wtan": interp[:, 3:6], "uv": interp[:, 6:8], "mat_id": mi >> 16,
            "object_id": rec[:, 29].to(torch.int32), "item_id": mi & 0xFFFF}
