"""Meshes and procedural geometry — counterpart of reference
Source/Engine/Scene/Mesh.h (multi-LOD vertex/index buffers, MeshLODData) and
MeshGenerator.h (triangle/quad/cube/sphere/cylinder/cone/grid generators with
LOD counts).

Geometry conventions match the reference so scenes look identical:
- Cube spans [-1, 1]^3 (MeshGenerator.h:227-292).
- Triangle(size): (-s,-s,0), (0,s,0), (s,-s,0), uv (0,1),(0.5,0),(1,1)
  (MeshGenerator.h:117-124).
- Left-handed world; front faces wind clockwise on screen (D3D default
  rasterizer state).

Unlike the reference's per-vertex C++ loops, generators here are vectorized
numpy — the data layout is struct-of-arrays ready for device upload.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class GeometryLOD:
    """One LOD level: SoA vertex data + triangle indices.

    morph_mid (optional, [V, 3]): per-vertex geomorph targets — the
    midpoint of the vertex's coarser-level parents. The renderer lerps
    positions toward these on device by a continuous per-item factor,
    giving the reference's distance-continuous tessellation
    (Tessellation.hlsl adaptive factors) without per-frame re-upload;
    None means the vertex never morphs."""
    positions: np.ndarray  # [V, 3] f32
    normals: np.ndarray    # [V, 3] f32
    tangents: np.ndarray   # [V, 3] f32
    uvs: np.ndarray        # [V, 2] f32
    indices: np.ndarray    # [T, 3] i32
    morph_mid: np.ndarray | None = None  # [V, 3] f32 geomorph targets

    @property
    def num_vertices(self) -> int:
        return int(self.positions.shape[0])

    @property
    def num_triangles(self) -> int:
        return int(self.indices.shape[0])

    def local_aabb(self) -> tuple[np.ndarray, np.ndarray]:
        lo = self.positions.min(axis=0)
        hi = self.positions.max(axis=0)
        center = 0.5 * (lo + hi)
        extents = 0.5 * (hi - lo)
        return center.astype(np.float32), np.maximum(extents, 1e-6).astype(np.float32)


@dataclass
class PatchSet:
    """Quad-domain tessellation patches (the reference's patch meshes,
    MeshGenerator.h PatchGrid + Tessellation.h:53-59): control-point data
    the per-frame amplification stage (ops/tessellation.py) expands into
    raster triangles with continuous fractional-odd factors. Corner order
    per patch: (u,v) = (0,0), (1,0), (0,1), (1,1)."""
    corners: np.ndarray    # [P, 4, 3] object space control points
    normals: np.ndarray    # [P, 4, 3]
    uvs: np.ndarray        # [P, 4, 2]
    heightmap: np.ndarray | None = None   # [S, S] displacement field
    disp_scale: float = 0.0               # world displacement amplitude
    tess_scale: float = 100.0             # distance where factor halves

    @property
    def num_patches(self) -> int:
        return int(self.corners.shape[0])


@dataclass
class Mesh:
    """Multi-LOD mesh (reference Mesh.h:61-74 MeshLODData).

    patches: optional quad-patch control data — the mesh then renders
    through the tessellation amplification stage in the main view; the
    regular lods hold the factor-1 (control) geometry used for shadow
    rendering and the AABB (the reference's shadow passes also tessellate;
    the coarse-shadow approximation is documented in docs/PARITY.md)."""
    name: str
    lods: list[GeometryLOD] = field(default_factory=list)
    patches: PatchSet | None = None

    @property
    def num_lods(self) -> int:
        return len(self.lods)

    def local_aabb(self) -> tuple[np.ndarray, np.ndarray]:
        c, e = self.lods[0].local_aabb()
        if self.patches is not None and self.patches.disp_scale:
            e = e + abs(self.patches.disp_scale)
        return c, e


def _make_lod(positions, normals, tangents, uvs, indices) -> GeometryLOD:
    return GeometryLOD(
        positions=np.ascontiguousarray(positions, dtype=np.float32),
        normals=np.ascontiguousarray(normals, dtype=np.float32),
        tangents=np.ascontiguousarray(tangents, dtype=np.float32),
        uvs=np.ascontiguousarray(uvs, dtype=np.float32),
        indices=np.ascontiguousarray(indices, dtype=np.int32),
    )


# ---------------------------------------------------------------------------
# Generators
# ---------------------------------------------------------------------------

def triangle(size: float = 1.0) -> Mesh:
    """Reference MeshGenerator.h:104-140."""
    s = np.float32(size)
    pos = np.array([[-s, -s, 0], [0, s, 0], [s, -s, 0]], dtype=np.float32)
    uv = np.array([[0, 1], [0.5, 0], [1, 1]], dtype=np.float32)
    nrm = np.tile(np.array([[0, 0, -1]], dtype=np.float32), (3, 1))
    tan = np.tile(np.array([[1, 0, 0]], dtype=np.float32), (3, 1))
    idx = np.array([[0, 1, 2]], dtype=np.int32)
    return Mesh("Triangle", [_make_lod(pos, nrm, tan, uv, idx)])


def quad(scale: float = 1.0) -> Mesh:
    """Unit quad in the XY plane facing -Z (toward a default LH camera)."""
    s = np.float32(scale)
    pos = np.array([[-s, s, 0], [s, s, 0], [s, -s, 0], [-s, -s, 0]], dtype=np.float32)
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], dtype=np.float32)
    nrm = np.tile(np.array([[0, 0, -1]], dtype=np.float32), (4, 1))
    tan = np.tile(np.array([[1, 0, 0]], dtype=np.float32), (4, 1))
    idx = np.array([[0, 1, 2], [0, 2, 3]], dtype=np.int32)
    return Mesh("Quad", [_make_lod(pos, nrm, tan, uv, idx)])


def cube() -> Mesh:
    """[-1,1]^3 cube, 24 vertices (4 per face), per-face normals/tangents/uvs
    (reference MeshGenerator.h:143-310)."""
    # face definition: (normal, tangent); vertices generated in clockwise
    # order viewed from outside (LH front-face winding).
    faces = [
        ((0, 1, 0), (1, 0, 0)),    # top
        ((0, 0, -1), (1, 0, 0)),   # front (faces camera at -Z)
        ((1, 0, 0), (0, 0, 1)),    # right
        ((0, 0, 1), (-1, 0, 0)),   # back
        ((-1, 0, 0), (0, 0, -1)),  # left
        ((0, -1, 0), (1, 0, 0)),   # bottom
    ]
    pos_list, nrm_list, tan_list, uv_list, idx_list = [], [], [], [], []
    for fi, (n, t) in enumerate(faces):
        n = np.array(n, dtype=np.float32)
        t = np.array(t, dtype=np.float32)
        b = np.cross(n, t)  # bitangent
        # corners in (t, b) plane, wound so cross(e1, e2) points outward
        # (matches reference cube top-face order, MeshGenerator.h:200-230)
        corners_tb = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], dtype=np.float32)
        pos = n[None, :] + corners_tb[:, 0:1] * t[None, :] + corners_tb[:, 1:2] * b[None, :]
        uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], dtype=np.float32)
        base = 4 * fi
        idx = np.array([[base, base + 1, base + 2], [base, base + 2, base + 3]], dtype=np.int32)
        pos_list.append(pos); nrm_list.append(np.tile(n, (4, 1)))
        tan_list.append(np.tile(t, (4, 1))); uv_list.append(uv); idx_list.append(idx)
    return Mesh("Cube", [_make_lod(
        np.concatenate(pos_list), np.concatenate(nrm_list),
        np.concatenate(tan_list), np.concatenate(uv_list), np.concatenate(idx_list))])


def _lod_counts(full: int, lod: int, minimum: int) -> int:
    return max(minimum, full >> lod)


def _uv_sphere_lod(radius: float, rings: int, slices: int) -> GeometryLOD:
    """Latitude/longitude sphere, vectorized. rings = latitude divisions,
    slices = longitude divisions."""
    ring_idx = np.arange(rings + 1, dtype=np.float32)           # 0..rings
    slice_idx = np.arange(slices + 1, dtype=np.float32)         # 0..slices (seam dup)
    theta = ring_idx / rings * np.pi                            # [0, pi] from +Y pole
    phi = slice_idx / slices * 2.0 * np.pi

    sin_t, cos_t = np.sin(theta), np.cos(theta)
    sin_p, cos_p = np.sin(phi), np.cos(phi)

    # grid [rings+1, slices+1]
    x = sin_t[:, None] * cos_p[None, :]
    y = cos_t[:, None] * np.ones_like(cos_p)[None, :]
    z = sin_t[:, None] * sin_p[None, :]
    n = np.stack([x, y, z], axis=-1).reshape(-1, 3)
    pos = radius * n
    # tangent = d(pos)/d(phi) normalized
    tx = -sin_t[:, None] * sin_p[None, :]
    tz = sin_t[:, None] * cos_p[None, :]
    tan = np.stack([tx, np.zeros_like(tx), tz], axis=-1).reshape(-1, 3)
    tlen = np.linalg.norm(tan, axis=-1, keepdims=True)
    tan = np.where(tlen > 1e-6, tan / np.maximum(tlen, 1e-12), np.array([[1, 0, 0]], dtype=np.float32))

    u = (slice_idx / slices)[None, :] * np.ones((rings + 1, 1), dtype=np.float32)
    v = (ring_idx / rings)[:, None] * np.ones((1, slices + 1), dtype=np.float32)
    uv = np.stack([u, v], axis=-1).reshape(-1, 2)

    # indices: quad (r, s) -> verts r*(S+1)+s ...
    r = np.arange(rings)[:, None]
    s = np.arange(slices)[None, :]
    v00 = (r * (slices + 1) + s)
    v01 = (r * (slices + 1) + s + 1)
    v10 = ((r + 1) * (slices + 1) + s)
    v11 = ((r + 1) * (slices + 1) + s + 1)
    # winding: cross(e1, e2) outward (LH front = clockwise on screen).
    # drop degenerate pole triangles: tri_a collapses on the first ring
    # (v00 == v01 at the +Y pole), tri_b on the last ring (-Y pole).
    tri_a = np.stack([v00[1:], v01[1:], v10[1:]], axis=-1).reshape(-1, 3)
    tri_b = np.stack([v01[:-1], v11[:-1], v10[:-1]], axis=-1).reshape(-1, 3)
    idx = np.concatenate([tri_a, tri_b], axis=0).astype(np.int32)
    return _make_lod(pos, n, tan, uv, idx)


def sphere(radius: float = 1.0, rings: int = 12, slices: int = 12, num_lods: int = 1) -> Mesh:
    """Reference MeshGenerator::Sphere (default engine sphere: radius 1,
    30 rings, 30 slices, 5 LODs — VQEngine_Render.cpp:258)."""
    lods = [
        _uv_sphere_lod(radius, _lod_counts(rings, i, 4), _lod_counts(slices, i, 4))
        for i in range(max(1, num_lods))
    ]
    return Mesh("Sphere", lods)


def _cylinder_lod(height: float, top_r: float, bottom_r: float, slices: int, stacks: int) -> GeometryLOD:
    half = height / 2.0
    phi = np.arange(slices + 1, dtype=np.float32) / slices * 2.0 * np.pi
    cos_p, sin_p = np.cos(phi), np.sin(phi)

    # side vertices: stacks+1 rows
    t = np.arange(stacks + 1, dtype=np.float32) / stacks       # 0 bottom -> 1 top
    y = -half + t * height
    r_row = bottom_r + t * (top_r - bottom_r)
    x = r_row[:, None] * cos_p[None, :]
    z = r_row[:, None] * sin_p[None, :]
    yy = y[:, None] * np.ones_like(cos_p)[None, :]
    pos = np.stack([x, yy, z], axis=-1).reshape(-1, 3)

    # side normals (slope-aware)
    dr = (bottom_r - top_r) / height
    nx = cos_p[None, :] * np.ones((stacks + 1, 1), dtype=np.float32)
    nz = sin_p[None, :] * np.ones((stacks + 1, 1), dtype=np.float32)
    ny = np.full_like(nx, dr)
    nrm = np.stack([nx, ny, nz], axis=-1).reshape(-1, 3)
    nrm = nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)

    tan = np.stack([-sin_p[None, :] * np.ones((stacks + 1, 1), dtype=np.float32),
                    np.zeros((stacks + 1, slices + 1), dtype=np.float32),
                    cos_p[None, :] * np.ones((stacks + 1, 1), dtype=np.float32)], axis=-1).reshape(-1, 3)
    u = (np.arange(slices + 1, dtype=np.float32) / slices)[None, :] * np.ones((stacks + 1, 1), dtype=np.float32)
    v = (1.0 - t)[:, None] * np.ones((1, slices + 1), dtype=np.float32)
    uv = np.stack([u, v], axis=-1).reshape(-1, 2)

    r = np.arange(stacks)[:, None]
    s = np.arange(slices)[None, :]
    v00 = (r * (slices + 1) + s).reshape(-1)        # lower row
    v01 = (r * (slices + 1) + s + 1).reshape(-1)
    v10 = ((r + 1) * (slices + 1) + s).reshape(-1)  # upper row
    v11 = ((r + 1) * (slices + 1) + s + 1).reshape(-1)
    side_idx = np.concatenate([
        np.stack([v00, v10, v11], axis=1),
        np.stack([v00, v11, v01], axis=1),
    ], axis=0)

    parts_pos, parts_nrm, parts_tan, parts_uv, parts_idx = [pos], [nrm], [tan], [uv], [side_idx]
    base = pos.shape[0]

    # caps (top then bottom): center + ring fan
    for cap_y, cap_r, ny_cap in ((half, top_r, 1.0), (-half, bottom_r, -1.0)):
        if cap_r <= 0.0:
            continue
        ring = np.stack([cap_r * cos_p, np.full_like(cos_p, cap_y), cap_r * sin_p], axis=-1)
        center = np.array([[0.0, cap_y, 0.0]], dtype=np.float32)
        cap_pos = np.concatenate([center, ring], axis=0)
        cap_nrm = np.tile(np.array([[0.0, ny_cap, 0.0]], dtype=np.float32), (cap_pos.shape[0], 1))
        cap_tan = np.tile(np.array([[1.0, 0.0, 0.0]], dtype=np.float32), (cap_pos.shape[0], 1))
        cap_uv = np.concatenate([
            np.array([[0.5, 0.5]], dtype=np.float32),
            np.stack([0.5 + 0.5 * cos_p, 0.5 + 0.5 * sin_p], axis=-1),
        ], axis=0)
        s1 = np.arange(slices)
        c = np.full_like(s1, 0)
        if ny_cap > 0:  # top: wind so outside (+Y) sees clockwise
            cap_idx = np.stack([c + base, base + 1 + s1 + 1, base + 1 + s1], axis=1)
        else:
            cap_idx = np.stack([c + base, base + 1 + s1, base + 1 + s1 + 1], axis=1)
        parts_pos.append(cap_pos); parts_nrm.append(cap_nrm); parts_tan.append(cap_tan)
        parts_uv.append(cap_uv); parts_idx.append(cap_idx)
        base += cap_pos.shape[0]

    return _make_lod(
        np.concatenate(parts_pos), np.concatenate(parts_nrm),
        np.concatenate(parts_tan), np.concatenate(parts_uv),
        np.concatenate(parts_idx).astype(np.int32))


def cylinder(height: float = 3.0, top_radius: float = 1.0, bottom_radius: float = 1.0,
             slices: int = 18, stacks: int = 6, num_lods: int = 1) -> Mesh:
    """Reference MeshGenerator::Cylinder (engine default: 3, 1, 1, 45, 6, 4 —
    VQEngine_Render.cpp:257)."""
    lods = [
        _cylinder_lod(height, top_radius, bottom_radius,
                      _lod_counts(slices, i, 6), _lod_counts(stacks, i, 1))
        for i in range(max(1, num_lods))
    ]
    return Mesh("Cylinder", lods)


def cone(height: float = 1.0, radius: float = 1.0, slices: int = 42, num_lods: int = 1) -> Mesh:
    """Reference MeshGenerator::Cone (engine default: 1, 1, 42, 4 —
    VQEngine_Render.cpp:261). Implemented as a zero-top-radius cylinder."""
    lods = [
        _cylinder_lod(height, 0.0, radius, _lod_counts(slices, i, 6), max(1, 2 >> i))
        for i in range(max(1, num_lods))
    ]
    m = Mesh("Cone", lods)
    # shift so base sits at y=0 like the reference cone (apex up)
    for lod in m.lods:
        lod.positions[:, 1] += np.float32(height / 2.0)
    return m


def _grid_lod(width: float, depth: float, nx: int, ny: int) -> GeometryLOD:
    """Flat grid in the XZ plane, +Y normal, centered at origin."""
    xs = np.linspace(-width / 2.0, width / 2.0, nx, dtype=np.float32)
    zs = np.linspace(depth / 2.0, -depth / 2.0, ny, dtype=np.float32)
    X, Z = np.meshgrid(xs, zs, indexing="xy")  # [ny, nx]
    pos = np.stack([X, np.zeros_like(X), Z], axis=-1).reshape(-1, 3)
    nrm = np.tile(np.array([[0, 1, 0]], dtype=np.float32), (pos.shape[0], 1))
    tan = np.tile(np.array([[1, 0, 0]], dtype=np.float32), (pos.shape[0], 1))
    u = (xs - xs[0]) / max(width, 1e-9)
    v = 1.0 - (zs - zs[-1]) / max(depth, 1e-9)
    U, V = np.meshgrid(u, v, indexing="xy")
    uv = np.stack([U, V], axis=-1).reshape(-1, 2)

    r = np.arange(ny - 1)[:, None]
    c = np.arange(nx - 1)[None, :]
    v00 = (r * nx + c).reshape(-1)
    v01 = (r * nx + c + 1).reshape(-1)
    v10 = ((r + 1) * nx + c).reshape(-1)
    v11 = ((r + 1) * nx + c + 1).reshape(-1)
    idx = np.concatenate([
        np.stack([v00, v01, v11], axis=1),
        np.stack([v00, v11, v10], axis=1),
    ], axis=0).astype(np.int32)
    return _make_lod(pos, nrm, tan, uv, idx)


def grid(width: float = 1.0, depth: float = 1.0, num_verts_x: int = 2, num_verts_y: int = 2,
         num_lods: int = 1) -> Mesh:
    """Reference MeshGenerator::Grid (engine defaults incl. the 1200x1200
    6-LOD terrain grid — VQEngine_Render.cpp:262-266)."""
    lods = [
        _grid_lod(width, depth, _lod_counts(num_verts_x, i, 2), _lod_counts(num_verts_y, i, 2))
        for i in range(max(1, num_lods))
    ]
    return Mesh("SimpleGrid", lods)


def grid_exact_halving(width: float, depth: float, cells: int = 64,
                       num_lods: int = 3) -> Mesh:
    """Grid whose LOD chain halves CELL counts exactly ((2^k)+1 vertices
    per side: 65 -> 33 -> 17 ...): each level's even-vertex subset lands
    exactly on the next-coarser level's vertices — the property CDLOD
    geomorphing needs so a fully morphed level k equals level k+1 and LOD
    switches are invisible (the continuous tess factors of
    Tessellation.hlsl:1-120, quantized levels + morph instead of fractional
    HS factors)."""
    assert cells & (cells - 1) == 0, "cells must be a power of two"
    lods = [_grid_lod(width, depth,
                      max(cells >> i, 1) + 1, max(cells >> i, 1) + 1)
            for i in range(max(1, num_lods))]
    return Mesh("GridExactHalving", lods)


def grid_geomorph_mids(positions: np.ndarray, nx: int, ny: int) -> np.ndarray:
    """Per-vertex geomorph targets for a row-major (ny, nx) grid — the
    domain-shader morph table: even-even vertices are their own target
    (they exist on the coarser level); odd-column vertices morph to the
    midpoint of their horizontal neighbors, odd-row to vertical neighbors,
    odd-odd to the triangulation diagonal's midpoint (the grid triangulates
    (v00,v01,v11),(v00,v11,v10), so the NW-SE diagonal is the real coarser
    edge). Call AFTER displacement so targets sit on the displaced coarse
    surface."""
    p = positions[: ny * nx].reshape(ny, nx, 3)
    mid = p.copy()
    rr = np.arange(ny)
    cc = np.arange(nx)
    odd_r = (rr % 2 == 1)[:, None]
    odd_c = (cc % 2 == 1)[None, :]
    left = p[:, np.clip(cc - 1, 0, nx - 1)]
    right = p[:, np.clip(cc + 1, 0, nx - 1)]
    up = p[np.clip(rr - 1, 0, ny - 1)]
    down = p[np.clip(rr + 1, 0, ny - 1)]
    nw = p[np.clip(rr - 1, 0, ny - 1)][:, np.clip(cc - 1, 0, nx - 1)]
    se = p[np.clip(rr + 1, 0, ny - 1)][:, np.clip(cc + 1, 0, nx - 1)]
    mid = np.where((odd_c & ~odd_r)[..., None], 0.5 * (left + right), mid)
    mid = np.where((odd_r & ~odd_c)[..., None], 0.5 * (up + down), mid)
    mid = np.where((odd_r & odd_c)[..., None], 0.5 * (nw + se), mid)
    out = positions.copy()
    out[: ny * nx] = mid.reshape(-1, 3)
    return out.astype(np.float32)


def patch_grid(width: float, depth: float, patches_x: int, patches_z: int,
               heightmap: np.ndarray | None = None,
               disp_scale: float = 0.0,
               tess_scale: float = 100.0,
               name: str = "PatchGrid") -> Mesh:
    """Quad-patch grid in the XZ plane, centered at the origin — the
    reference's tessellated grid/terrain patch mesh (MeshGenerator.h patch
    meshes; VQEngine_Render.cpp:277-280). Returns a Mesh whose `patches`
    drive the per-frame amplification stage and whose single LOD holds the
    factor-1 control geometry (displaced at the control vertices — exactly
    what the amplifier emits at factor 1) for shadows/AABB."""
    nx, nz = patches_x + 1, patches_z + 1
    xs = (np.arange(nx) / patches_x - 0.5) * width
    zs = (np.arange(nz) / patches_z - 0.5) * depth
    gx, gz = np.meshgrid(xs, zs, indexing="xy")              # [nz, nx]
    gpos = np.stack([gx, np.zeros_like(gx), gz], axis=-1).astype(np.float32)
    guv = np.stack([np.broadcast_to(np.arange(nx) / patches_x, (nz, nx)),
                    np.broadcast_to((np.arange(nz) / patches_z)[:, None],
                                    (nz, nx))], axis=-1).astype(np.float32)

    corners, uvs = [], []
    for j in range(patches_z):
        for i in range(patches_x):
            # corner order (u,v) = (0,0), (1,0), (0,1), (1,1)
            corners.append([gpos[j, i], gpos[j, i + 1],
                            gpos[j + 1, i], gpos[j + 1, i + 1]])
            uvs.append([guv[j, i], guv[j, i + 1],
                        guv[j + 1, i], guv[j + 1, i + 1]])
    corners = np.asarray(corners, np.float32)
    uvs = np.asarray(uvs, np.float32)
    normals = np.broadcast_to(
        np.asarray([0, 1, 0], np.float32), corners.shape).copy()
    ps = PatchSet(corners=corners, normals=normals, uvs=uvs,
                  heightmap=heightmap, disp_scale=float(disp_scale),
                  tess_scale=float(tess_scale))

    # factor-1 geometry: the control grid displaced at its vertices
    pos = gpos.reshape(-1, 3).copy()
    uvf = guv.reshape(-1, 2)
    if heightmap is not None and disp_scale:
        # bilinear, exactly like ops/tessellation.displace — factor-1
        # amplification must reproduce this geometry bit-for-bit
        hh, wh = heightmap.shape
        x = np.clip(uvf[:, 0] * (wh - 1), 0.0, wh - 1.0)
        y = np.clip(uvf[:, 1] * (hh - 1), 0.0, hh - 1.0)
        x0 = np.floor(x).astype(int)
        y0 = np.floor(y).astype(int)
        fx, fy = x - x0, y - y0
        x1 = np.minimum(x0 + 1, wh - 1)
        y1 = np.minimum(y0 + 1, hh - 1)
        h = ((heightmap[y0, x0] * (1 - fx) + heightmap[y0, x1] * fx)
             * (1 - fy)
             + (heightmap[y1, x0] * (1 - fx) + heightmap[y1, x1] * fx)
             * fy)
        pos[:, 1] += h * disp_scale
    tris = []
    for j in range(patches_z):
        for i in range(patches_x):
            v00 = j * nx + i
            v10 = v00 + 1
            v01 = v00 + nx
            v11 = v01 + 1
            # matches build_patch_template's (i+j) even diagonal at segs=1
            tris.append((v00, v01, v10))
            tris.append((v10, v01, v11))
    lod = _make_lod(pos,
                    np.broadcast_to(np.asarray([0, 1, 0], np.float32),
                                    pos.shape).copy(),
                    np.broadcast_to(np.asarray([1, 0, 0], np.float32),
                                    pos.shape).copy(),
                    uvf.copy(), np.asarray(tris, np.int32))
    return Mesh(name, [lod], patches=ps)


def fullscreen_quad() -> Mesh:
    """NDC-space fullscreen quad (reference FullScreenQuad / fullscreen
    triangle blits)."""
    m = quad(1.0)
    m.name = "FullScreenQuad"
    return m


def subdivide(lod: GeometryLOD, levels: int = 1) -> GeometryLOD:
    """Midpoint (1:4) triangle subdivision — the TPU-native stand-in for
    the reference's hull/domain-shader tessellation (Tessellation.hlsl:
    tri/quad domains with adaptive factors). Geometry amplification happens
    at load time; adaptivity comes from the LOD system instead of
    per-patch factors."""
    out = lod
    for _ in range(levels):
        v = out.positions.shape[0]
        tri = out.indices
        # midpoint vertices per edge (deduplicated via sorted edge keys)
        e = np.concatenate([tri[:, [0, 1]], tri[:, [1, 2]], tri[:, [2, 0]]])
        e_sorted = np.sort(e, axis=1)
        keys = e_sorted[:, 0].astype(np.int64) * v + e_sorted[:, 1]
        uniq, inv = np.unique(keys, return_inverse=True)
        ua = (uniq // v).astype(np.int64)
        ub = (uniq % v).astype(np.int64)

        def mid(attr):
            return 0.5 * (attr[ua] + attr[ub])

        mpos = mid(out.positions)
        mnrm = mid(out.normals)
        n = np.linalg.norm(mnrm, axis=1, keepdims=True)
        mnrm = np.where(n > 1e-9, mnrm / np.maximum(n, 1e-12), [0, 1, 0])
        mtan = mid(out.tangents)
        muv = mid(out.uvs)

        m01 = v + inv[: len(tri)]
        m12 = v + inv[len(tri): 2 * len(tri)]
        m20 = v + inv[2 * len(tri):]
        a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
        new_idx = np.concatenate([
            np.stack([a, m01, m20], 1),
            np.stack([m01, b, m12], 1),
            np.stack([m20, m12, c], 1),
            np.stack([m01, m12, m20], 1),
        ]).astype(np.int32)
        out = GeometryLOD(
            positions=np.concatenate([out.positions, mpos]).astype(np.float32),
            normals=np.concatenate([out.normals, mnrm]).astype(np.float32),
            tangents=np.concatenate([out.tangents, mtan]).astype(np.float32),
            uvs=np.concatenate([out.uvs, muv]).astype(np.float32),
            indices=new_idx)
    return out


def displace(lod: GeometryLOD, heightmap: np.ndarray, amount: float,
             direction=(0.0, 1.0, 0.0)) -> GeometryLOD:
    """Heightmap vertex displacement (the domain-shader displacement,
    ForwardLighting.hlsl CalcHeightOffset / Tessellation.hlsl), baked at
    load: position += dir * height(uv) * amount."""
    h, w = heightmap.shape[:2]
    u = np.clip((lod.uvs[:, 0] % 1.0) * (w - 1), 0, w - 1).astype(int)
    v = np.clip((lod.uvs[:, 1] % 1.0) * (h - 1), 0, h - 1).astype(int)
    hv = heightmap[v, u] if heightmap.ndim == 2 else heightmap[v, u, 0]
    pos = lod.positions + np.asarray(direction, np.float32)[None] \
        * (hv * amount)[:, None]
    return GeometryLOD(positions=pos.astype(np.float32), normals=lod.normals,
                       tangents=lod.tangents, uvs=lod.uvs, indices=lod.indices)


# Builtin mesh registry mirroring EBuiltInMeshes + GenerateBuiltinMeshes
# (reference VQEngine_Render.cpp:228-285)
BUILTIN_MESH_BUILDERS = {
    "Triangle": lambda: triangle(1.0),
    "Cube": cube,
    "Cylinder": lambda: cylinder(3.0, 1.0, 1.0, 45, 6, 4),
    "Sphere": lambda: sphere(1.0, 30, 30, 5),
    "Cone": lambda: cone(1.0, 1.0, 42, 4),
    "SimpleGrid": lambda: grid(1.0, 1.0, 2, 2, 1),
    "DetaildGrid0": lambda: grid(1.0, 1.0, 3, 3, 1),
    "DetaildGrid1": lambda: grid(1.0, 1.0, 12, 12, 4),
    "DetaildGrid2": lambda: grid(1.0, 1.0, 1200, 1200, 6),
}


class LazyMeshRegistry:
    """Builds builtin meshes on first use (the 1200x1200 terrain grid is
    ~2.9M triangles; generating it eagerly costs seconds at startup)."""

    def __init__(self, builders=None):
        self._builders = dict(builders or BUILTIN_MESH_BUILDERS)
        self._cache: dict[str, Mesh] = {}

    def get(self, name: str, default=None):
        if name in self._cache:
            return self._cache[name]
        fn = self._builders.get(name)
        if fn is None:
            return default
        m = fn()
        m.name = name
        self._cache[name] = m
        return m

    def __contains__(self, name: str) -> bool:
        return name in self._builders

    def names(self):
        return list(self._builders)


def build_builtin_meshes() -> LazyMeshRegistry:
    return LazyMeshRegistry()
