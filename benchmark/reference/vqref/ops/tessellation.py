"""Quad- and tri-domain patch tessellation — counterpart of
``vqengine_tpu/ops/tessellation.py`` (the reference's hull/domain-shader
pipeline, Shaders/Tessellation.hlsl: fractional-odd partitioning,
per-edge distance factors, the hull shader's frustum cull).

Every patch amplifies through a static template at the maximum level
(MAX_SEGS segments per edge); the per-frame factor moves the template's
parametric coordinates (fractional-odd snapping), and template vertices
past the live level collapse onto their neighbours. Collapsed triangles
are found exactly, by equality of their snapped parameters, so the
snapped parameters must be bitwise the reference's: one flipped equality
adds or drops a sliver triangle. The outputs have the reference's static
shapes: T' = P * len(tri_idx) triangles, padded to a multiple of 128,
with the same `tri_live` mask.

Rounding (ROADMAP queue 3): the reference runs op by op, so each
elementwise op rounds on its own and the port writes the same ops in the
same order. Where one compiled op sums several products, the port sums as
XLA's CPU backend does (measured on random inputs against the op-by-op
reference): the batched einsums "pij,pcj->pci" (the control corners to
world) and "pvk,pkc->pvc" (tri-patch evaluation) are chains of fused
multiply-adds (raster.matvec_fma), the cull's "kj,pcj->pkc" sums its four
products in pairs (an FMA chain for a single patch), `jnp.linalg.norm` is
an FMA chain (shadow.norm3), `jnp.cross` is `texture.cross_xla`, and a
three-term `sum(-1)` adds left to right. The factors divide a Python
number by a tensor and the tri inner factor divides by 3: both go through
`raster.div_true` (PyTorch's `c / t` is `t.reciprocal() * c`, and on a
card `t / 3.0` is a product with the reciprocal).

The host-side templates (build_patch_template, build_tri_template) are
the reference's, verbatim.
"""
from __future__ import annotations

import numpy as np
import torch

from .raster import _fma, div_true, matvec_fma, scalar_on
from .shadow import norm3
from .texture import cross_xla

# template resolution: MAX_SEGS segments per edge (must be odd for the
# fractional-odd ladder to top out exactly uniform)
MAX_SEGS = 7


def build_patch_template(max_segs: int = MAX_SEGS):
    """Static template for one quad patch: parametric vertex grid and
    triangle index list.

    Returns (params [V, 2] f32 in [0,1]^2 with V=(max_segs+1)^2,
    tri_idx [T, 3] int32 with T=2*max_segs^2). Triangles alternate
    diagonals per cell (matches MeshGenerator.h's grid winding)."""
    m = max_segs
    us, vs = np.meshgrid(np.arange(m + 1) / m, np.arange(m + 1) / m,
                         indexing="xy")
    params = np.stack([us.reshape(-1), vs.reshape(-1)],
                      axis=-1).astype(np.float32)
    tris = []
    for j in range(m):
        for i in range(m):
            v00 = j * (m + 1) + i
            v10 = v00 + 1
            v01 = v00 + (m + 1)
            v11 = v01 + 1
            if (i + j) % 2 == 0:
                tris.append((v00, v01, v10))
                tris.append((v10, v01, v11))
            else:
                tris.append((v00, v01, v11))
                tris.append((v00, v11, v10))
    return params, np.asarray(tris, np.int32)


def build_tri_template(max_segs: int = MAX_SEGS):
    """Static template for one TRIANGLE patch (the reference's tri-domain
    hull/domain path, Tessellation.hlsl "domain(tri)"): barycentric
    vertex grid at max_segs uniform subdivisions and its triangle list.

    Returns (bary [V, 3] f32 with V=(m+1)(m+2)/2 rows summing to 1,
    tri_idx [T, 3] int32 with T = m^2)."""
    m = max_segs
    verts = []
    vid = {}
    for j in range(m + 1):
        for i in range(m + 1 - j):
            vid[(i, j)] = len(verts)
            verts.append((i / m, j / m, (m - i - j) / m))
    tris = []
    for j in range(m):
        for i in range(m - j):
            tris.append((vid[(i, j)], vid[(i + 1, j)], vid[(i, j + 1)]))
            if i < m - j - 1:
                tris.append((vid[(i + 1, j)], vid[(i + 1, j + 1)],
                             vid[(i, j + 1)]))
    return (np.asarray(verts, np.float32),
            np.asarray(tris, np.int32))


def frac_odd_snap(u: torch.Tensor, f: torch.Tensor,
                  max_segs: int = MAX_SEGS) -> torch.Tensor:
    """Fractional-odd parametric snap: template coordinate u in [0, 1]
    (at max_segs uniform segments) -> live coordinate under the continuous
    factor f (broadcastable with u; clamped to [1, max_segs]). Vertices
    are labelled by their centre offset s = u * m - m / 2, so each keeps
    its position continuous across the odd-integer jumps of n = ceil_odd(f);
    those with |s| > n / 2 collapse onto the endpoints; the inner ones sit
    at 0.5 + s (1 - 2e) / (n - 2) with e = (f - (n - 2)) / (2 f)."""
    m = float(max_segs)
    f = torch.clamp(f, 1.0, m)
    # smallest odd integer >= f (n >= 1); / 2 is exact on every device
    n = 2.0 * torch.ceil((f - 1.0) / 2.0) + 1.0
    e = (f - (n - 2.0)) / (2.0 * f)
    s = u * m - 0.5 * m                          # signed centre offset
    lo, hi = -0.5 * n, 0.5 * n
    sc = torch.minimum(torch.maximum(s, lo), hi)  # collapse to endpoints
    # n == 1 has no interior vertices; the where() picks the endpoints
    denom = torch.clamp(n - 2.0, min=1.0)
    p_in = 0.5 + sc * (1.0 - 2.0 * e) / denom
    return torch.where(sc <= lo, 0.0, torch.where(sc >= hi, 1.0, p_in))


def _factor(mid: torch.Tensor, camera_pos: torch.Tensor, tess_scale: float,
            max_segs: int) -> torch.Tensor:
    """max_segs * tess_scale / max(|mid - camera|, 1e-3), clamped to
    [1, max_segs]: the numerator is a Python number rounded to f32 once,
    divided by the tensor (not multiplied by its reciprocal)."""
    d = norm3(mid - camera_pos)
    return torch.clamp(div_true(max_segs * tess_scale, torch.clamp(d, min=1e-3)),
                       1.0, float(max_segs))


def edge_factors(corners_world: torch.Tensor, camera_pos: torch.Tensor,
                 tess_scale: float, max_segs: int = MAX_SEGS):
    """Per-edge distance factors of quad patches from each edge
    midpoint's camera distance (shared midpoints give shared factors, so
    seams are crack-free), plus the inner factor. corners_world [P, 4, 3]
    in (u, v) order (0,0), (1,0), (0,1), (1,1) -> (fu0, fu1, fv0, fv1,
    f_inner), each [P]: fu0/fu1 split the v=0 / v=1 edges, fv0/fv1 the
    u=0 / u=1 edges."""
    c00, c10, c01, c11 = corners_world.unbind(1)

    def fac(mid):
        return _factor(mid, camera_pos, tess_scale, max_segs)

    fu0 = fac(0.5 * (c00 + c10))        # v = 0 edge
    fu1 = fac(0.5 * (c01 + c11))        # v = 1 edge
    fv0 = fac(0.5 * (c00 + c01))        # u = 0 edge
    fv1 = fac(0.5 * (c10 + c11))        # u = 1 edge
    f_inner = 0.25 * (((fu0 + fu1) + fv0) + fv1)
    return fu0, fu1, fv0, fv1, f_inner


def snap_params(params: torch.Tensor, fu0, fu1, fv0, fv1, f_inner,
                max_segs: int = MAX_SEGS) -> torch.Tensor:
    """Fractional-odd snapping of the template grid per patch: params
    [V, 2], factors [P] each -> snapped [P, V, 2]. Boundary rows take
    their edge's factor, interior vertices the inner factor."""
    u = params[None, :, 0]
    v = params[None, :, 1]
    f_u = torch.where(v <= 0.0, fu0[:, None],
                      torch.where(v >= 1.0, fu1[:, None], f_inner[:, None]))
    f_v = torch.where(u <= 0.0, fv0[:, None],
                      torch.where(u >= 1.0, fv1[:, None], f_inner[:, None]))
    return torch.stack([frac_odd_snap(u, f_u, max_segs),
                        frac_odd_snap(v, f_v, max_segs)], dim=-1)


def eval_patches(corners: torch.Tensor, uv01: torch.Tensor) -> torch.Tensor:
    """Bilinear quad-patch evaluation: corners [P, 4, C] (order (0,0),
    (1,0), (0,1), (1,1)), uv01 [P, V, 2] -> [P, V, C]."""
    u = uv01[..., 0:1]
    v = uv01[..., 1:2]
    c00, c10, c01, c11 = (corners[:, None, 0], corners[:, None, 1],
                          corners[:, None, 2], corners[:, None, 3])
    return ((c00 * (1 - u) + c10 * u) * (1 - v)
            + (c01 * (1 - u) + c11 * u) * v)


def displace_texels(uv: torch.Tensor, hh: int, wh: int):
    """The bilinear height tap's texel selection at uv (edge-clamped) ->
    (x0i, y0i int64, fx, fy)."""
    x = torch.clamp(uv[..., 0] * (wh - 1), 0.0, wh - 1.0)
    y = torch.clamp(uv[..., 1] * (hh - 1), 0.0, hh - 1.0)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    return x0.long(), y0.long(), (x - x0)[..., None], (y - y0)[..., None]


def displace(positions: torch.Tensor, normals: torch.Tensor,
             uv: torch.Tensor, heightmap: torch.Tensor,
             scale: float) -> torch.Tensor:
    """Heightmap displacement along the patch normal (the domain shader's
    displacement): the bilinear height at uv (edge-clamped), positions +
    normals * h * scale. uv/positions/normals [P, V, .]; heightmap [Hh, Wh]."""
    hh, wh = heightmap.shape
    x0i, y0i, fx, fy = displace_texels(uv, hh, wh)
    x1i = torch.clamp(x0i + 1, max=wh - 1)
    y1i = torch.clamp(y0i + 1, max=hh - 1)
    flat = heightmap.reshape(-1)
    h00 = flat[y0i * wh + x0i][..., None]
    h10 = flat[y0i * wh + x1i][..., None]
    h01 = flat[y1i * wh + x0i][..., None]
    h11 = flat[y1i * wh + x1i][..., None]
    h = ((h00 * (1 - fx) + h10 * fx) * (1 - fy)
         + (h01 * (1 - fx) + h11 * fx) * fy)
    return positions + normals * h * scale


def cull_patches(corners_world: torch.Tensor, frustum_planes: torch.Tensor,
                 slack: float = 0.0) -> torch.Tensor:
    """Per-patch frustum cull (the hull shader's zero-factor path): a
    patch survives unless all its control corners lie outside one plane
    by more than `slack`. corners_world [P, C, 3], planes [6, 4] -> [P]
    bool. The reference's einsum "kj,pcj->pkc" sums its four products in
    pairs, or as an FMA chain where there is a single patch."""
    c4 = torch.cat([corners_world, torch.ones_like(corners_world[..., :1])],
                   dim=-1)
    pl = frustum_planes[None, :, None, :]                     # [1, 6, 1, 4]
    c = c4[:, None]                                           # [P, 1, C, 4]
    if corners_world.shape[0] == 1:
        d = pl[..., 0] * c[..., 0]
        for j in range(1, 4):
            d = _fma(pl[..., j], c[..., j], d)
    else:
        t = [pl[..., j] * c[..., j] for j in range(4)]
        d = (t[0] + t[1]) + (t[2] + t[3])                     # [P, 6, C]
    outside = (d < scalar_on(-slack, d.device)).all(dim=2).any(dim=1)
    return ~outside


def snap_bary(bary: torch.Tensor, f_e0, f_e1, f_e2, f_inner,
              max_segs: int = MAX_SEGS) -> torch.Tensor:
    """Fractional-odd snapping on the tri domain: template barycentrics
    [V, 3] + per-patch edge and inner factors [P] -> snapped [P, V, 3].
    Boundary vertices (some b_k == 0) snap along their edge with the 1-D
    snap (symmetric, so two patches sharing an edge agree); interior
    vertices snap their ring coordinate rho = 1 - 3 min(b) through the
    1-D snap's lower half, collapsing on the centroid at f_inner = 1."""
    b0 = bary[None, :, 0]
    b1 = bary[None, :, 1]
    b2 = bary[None, :, 2]
    on_e0 = b0 <= 0.0
    on_e1 = b1 <= 0.0
    on_e2 = b2 <= 0.0
    boundary = on_e0 | on_e1 | on_e2
    f_edge = torch.where(on_e0, f_e0[:, None],
                         torch.where(on_e1, f_e1[:, None], f_e2[:, None]))
    # edge coordinate: on e0 (b0=0) t = b1; on e1 (b1=0) t = b2; on e2 t = b0
    t = torch.where(on_e0, b1, torch.where(on_e1, b2, b0))
    ts = frac_odd_snap(t, f_edge, max_segs)
    eb0 = torch.where(on_e0, 0.0, torch.where(on_e1, 1.0 - ts, ts))
    eb1 = torch.where(on_e0, ts, torch.where(on_e1, 0.0, 1.0 - ts))
    eb2 = 1.0 - eb0 - eb1
    edge_b = torch.stack([eb0, eb1, eb2], dim=-1)

    bmin = torch.minimum(b0, torch.minimum(b1, b2))
    rho = 1.0 - 3.0 * bmin
    xs = frac_odd_snap(0.5 * rho, f_inner[:, None], max_segs)
    rho_s = 2.0 * xs
    scale = torch.where(rho > 0.0, rho_s / torch.clamp(rho, min=1e-12), 0.0)
    third = 1.0 / 3.0
    inner_b = third + (bary[None] - third) * scale[..., None]
    return torch.where(boundary[..., None], edge_b, inner_b)


def tri_edge_factors(corners_world: torch.Tensor, camera_pos: torch.Tensor,
                     tess_scale: float, max_segs: int = MAX_SEGS):
    """Per-edge distance factors of tri patches (edge k opposite corner
    k). corners_world [P, 3, 3] -> (f_e0, f_e1, f_e2, f_inner), each [P]."""
    c0, c1, c2 = corners_world.unbind(1)

    def fac(mid):
        return _factor(mid, camera_pos, tess_scale, max_segs)

    f_e0 = fac(0.5 * (c1 + c2))
    f_e1 = fac(0.5 * (c2 + c0))
    f_e2 = fac(0.5 * (c0 + c1))
    f_inner = div_true((f_e0 + f_e1) + f_e2, 3.0)
    return f_e0, f_e1, f_e2, f_inner


def eval_tri_patches(corners: torch.Tensor, bary: torch.Tensor) -> torch.Tensor:
    """Barycentric tri-patch evaluation: corners [P, 3, C], bary [P, V, 3]
    -> [P, V, C], the three products an FMA chain (the reference's einsum
    "pvk,pkc->pvc" on the CPU, for more than one patch)."""
    acc = bary[..., 0:1] * corners[:, None, 0]
    for k in (1, 2):
        acc = _fma(bary[..., k:k + 1], corners[:, None, k], acc)
    return acc + 0.0                  # XLA's accumulator starts at +0


def _world_corners(patch_corners: torch.Tensor, patch_item: torch.Tensor,
                   world: torch.Tensor) -> torch.Tensor:
    """Control corners [P, C, 3] through their items' world matrices
    (the einsum "pij,pcj->pci": an FMA chain over j)."""
    w_rows = world[patch_item.long()][:, :3, :]                # [P, 3, 4]
    c4 = torch.cat([patch_corners, torch.ones_like(patch_corners[..., :1])],
                   dim=-1)
    return matvec_fma(w_rows[:, None], c4)                     # [P, C, 3]


def _geometric_normal(pos, pu, pv, nrm):
    """The displaced surface's normal from two finite differences,
    turned into the control normal's hemisphere and normalized."""
    g = cross_xla(pu - pos, pv - pos)
    t = g * nrm
    s = (t[..., 0:1] + t[..., 1:2]) + t[..., 2:3]
    flip = torch.where(torch.isnan(s), s, torch.sign(s))      # jnp.sign
    g = g * torch.where(flip == 0.0, 1.0, flip)
    return g / torch.clamp(norm3(g), min=1e-12)[..., None]


def _unit(v: torch.Tensor, eps: float) -> torch.Tensor:
    return v / torch.clamp(norm3(v), min=eps)[..., None]


def _corner_tables(pos, nrm, tan, uv, tri_idx, patch_item, live, collapsed,
                   pad_to: int):
    """Per-vertex [P, V, .] tables -> the per-corner tables [3T', .],
    tri_item and tri_live [T'], padded to a multiple of pad_to with
    zero-area dead triangles."""
    p, vn = pos.shape[0], pos.shape[1]
    t = tri_idx.shape[0]
    flat_idx = (torch.arange(p, device=pos.device)[:, None, None] * vn
                + tri_idx.long()[None]).reshape(-1)
    corner_pos = pos.reshape(-1, 3)[flat_idx]
    corner_nrm = nrm.reshape(-1, 3)[flat_idx]
    corner_tan = tan.reshape(-1, 3)[flat_idx]
    corner_uv = uv.reshape(-1, 2)[flat_idx]
    tri_item = patch_item.repeat_interleave(t)
    tri_live = live.repeat_interleave(t) & ~collapsed.reshape(-1)
    n_pad = (-(p * t)) % pad_to
    if n_pad:
        def padr(a, rows):
            return torch.cat([a, a.new_zeros((rows,) + a.shape[1:])])
        corner_pos = padr(corner_pos, 3 * n_pad)
        corner_nrm = padr(corner_nrm, 3 * n_pad)
        corner_tan = padr(corner_tan, 3 * n_pad)
        corner_uv = padr(corner_uv, 3 * n_pad)
        tri_item = padr(tri_item, n_pad)
        tri_live = padr(tri_live, n_pad)
    return corner_pos, corner_nrm, corner_tan, corner_uv, tri_item, tri_live


def _collapsed(snapped: torch.Tensor, tri_idx: torch.Tensor) -> torch.Tensor:
    """[P, V, D] snapped parameters -> [P, T] bool: two corners of a
    template triangle share their snapped parameters exactly."""
    tb = snapped[:, tri_idx.long()]                           # [P, T, 3, D]
    return ((tb[:, :, 0] == tb[:, :, 1]).all(-1)
            | (tb[:, :, 1] == tb[:, :, 2]).all(-1)
            | (tb[:, :, 0] == tb[:, :, 2]).all(-1))


def amplify_tri(patch_corners: torch.Tensor, patch_normals: torch.Tensor,
                patch_uvs: torch.Tensor, patch_item: torch.Tensor,
                world: torch.Tensor, camera_pos: torch.Tensor,
                frustum_planes: torch.Tensor,
                bary: torch.Tensor, tri_idx: torch.Tensor,
                tess_scale: float,
                heightmap: torch.Tensor | None = None,
                disp_scale: float = 0.0,
                max_segs: int = MAX_SEGS,
                pad_to: int = 128):
    """Tri-domain amplification (the material-driven path: the base
    triangles of an item whose material enables tessellation are its
    control patches), as amplify() for quads: per-edge fractional-odd
    factors, the per-patch cull, optional displacement along the control
    normal with the normal recomputed from the displaced surface. Returns
    the same corner-table tuple as amplify()."""
    corners_w = _world_corners(patch_corners, patch_item, world)
    f_e0, f_e1, f_e2, f_inner = tri_edge_factors(
        corners_w, camera_pos, tess_scale, max_segs)
    live = cull_patches(corners_w, frustum_planes,
                        slack=abs(disp_scale) + 1e-3)

    b = snap_bary(bary, f_e0, f_e1, f_e2, f_inner, max_segs)  # [P, V, 3]
    collapsed = _collapsed(b, tri_idx)

    pos = eval_tri_patches(patch_corners, b)
    nrm = eval_tri_patches(patch_normals, b)
    uv = eval_tri_patches(patch_uvs, b)
    if heightmap is not None and disp_scale != 0.0:
        def surf(bb):
            return displace(eval_tri_patches(patch_corners, bb),
                            eval_tri_patches(patch_normals, bb),
                            eval_tri_patches(patch_uvs, bb),
                            heightmap, disp_scale)

        eps = 0.25 / max_segs
        pos = surf(b)
        # probe along two barycentric directions, flipping where the
        # step would leave the simplex
        du = torch.where(b[..., 0:1] + eps <= 1.0 - b[..., 1:2], eps, -eps)
        dv = torch.where(b[..., 1:2] + eps <= 1.0 - b[..., 0:1], eps, -eps)
        zero = torch.zeros_like(du)
        pu = surf(b + torch.cat([du, zero, -du], dim=-1))
        pv = surf(b + torch.cat([zero, dv, -dv], dim=-1))
        nrm = _geometric_normal(pos, pu, pv, nrm)
    # tangent: the c0 -> c1 control edge (constant per patch)
    tan = (patch_corners[:, None, 1] - patch_corners[:, None, 0]).expand(pos.shape)
    tan = _unit(tan, 1e-9)
    return _corner_tables(pos, nrm, tan, uv, tri_idx, patch_item, live,
                          collapsed, pad_to)


def amplify(patch_corners: torch.Tensor, patch_normals: torch.Tensor,
            patch_uvs: torch.Tensor, patch_item: torch.Tensor,
            world: torch.Tensor, camera_pos: torch.Tensor,
            frustum_planes: torch.Tensor,
            params: torch.Tensor, tri_idx: torch.Tensor,
            tess_scale: float,
            heightmap: torch.Tensor | None = None,
            disp_scale: float = 0.0,
            max_segs: int = MAX_SEGS,
            pad_to: int = 128):
    """The per-frame amplification of quad patches into raster corner
    tables (hull shader, tessellator and domain shader in one pass).

    patch_corners/normals [P, 4, 3], patch_uvs [P, 4, 2] (object space),
    patch_item [P] item ids, world [N, 4, 4], params/tri_idx from
    build_patch_template -> (corner_pos [3T', 3] object space, corner_nrm
    [3T', 3], corner_tan [3T', 3], corner_uv [3T', 2], tri_item [T'],
    tri_live [T'] bool), T' = P * len(tri_idx) rounded up to pad_to;
    culled patches and collapsed template triangles are dead."""
    corners_w = _world_corners(patch_corners, patch_item, world)
    fu0, fu1, fv0, fv1, f_inner = edge_factors(
        corners_w, camera_pos, tess_scale, max_segs)
    live = cull_patches(corners_w, frustum_planes,
                        slack=abs(disp_scale) + 1e-3)

    uv01 = snap_params(params, fu0, fu1, fv0, fv1, f_inner, max_segs)
    # collapsed template triangles die exactly, in parameter space (their
    # clip-space determinant is only about 0)
    collapsed = _collapsed(uv01, tri_idx)
    pos = eval_patches(patch_corners, uv01)                  # [P, V, 3]
    nrm = eval_patches(patch_normals, uv01)
    uv = eval_patches(patch_uvs, uv01)
    if heightmap is not None and disp_scale != 0.0:
        def surf(uvp):
            return displace(eval_patches(patch_corners, uvp),
                            eval_patches(patch_normals, uvp),
                            eval_patches(patch_uvs, uvp),
                            heightmap, disp_scale)

        eps = 0.25 / max_segs
        pos = surf(uv01)
        # one-sided differences that flip to backward at the far edges
        du = torch.where(uv01[..., 0:1] + eps <= 1.0, eps, -eps)
        dv = torch.where(uv01[..., 1:2] + eps <= 1.0, eps, -eps)
        zero = torch.zeros_like(du)
        pu = surf(uv01 + torch.cat([du, zero], dim=-1))
        pv = surf(uv01 + torch.cat([zero, dv], dim=-1))
        nrm = _geometric_normal(pos, pu, pv, nrm)
    # tangent = d(bilinear)/du
    v01 = uv01[..., 1:2]
    tan = ((patch_corners[:, None, 1] - patch_corners[:, None, 0]) * (1 - v01)
           + (patch_corners[:, None, 3] - patch_corners[:, None, 2]) * v01)
    tan = _unit(tan, 1e-9)
    return _corner_tables(pos, nrm, tan, uv, tri_idx, patch_item, live,
                          collapsed, pad_to)
