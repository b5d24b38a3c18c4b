"""Debug draws — counterpart of the reference's debug geometry passes
(SceneRendering.cpp: RenderBoundingBoxes :1853, RenderLightBounds :1940,
RenderDebugVertexAxes :2018; light gizmo meshes drawn unlit via Unlit.hlsl).

TPU-native approach: debug geometry becomes extra draw items fed through
the SAME rasterizer with emissive-only ("unlit") materials — no separate
wireframe pipeline state, the instanced-wireframe capability maps to
edge-tube boxes.
"""
from __future__ import annotations

import numpy as np

from ..scene.light import ELightType
from ..scene.material import Material
from ..scene.mesh import GeometryLOD, Mesh, cone, sphere
from ..utils import math3d as m3
from .scene_buffers import DrawItem


def edge_tube_box(thickness: float = 0.02) -> Mesh:
    """A [-1,1]^3 box drawn as 12 thin edge tubes (the wireframe analog)."""
    pos_l, nrm_l, tan_l, uv_l, idx_l = [], [], [], [], []
    base = 0
    # each edge: axis-aligned thin box
    edges = []
    for axis in range(3):
        for s1 in (-1, 1):
            for s2 in (-1, 1):
                lo = [-1.0, -1.0, -1.0]
                hi = [1.0, 1.0, 1.0]
                a1, a2 = [(1, 2), (0, 2), (0, 1)][axis]
                lo[a1] = hi[a1] = s1
                lo[a2] = hi[a2] = s2
                edges.append((axis, np.array(lo), np.array(hi)))
    for axis, lo, hi in edges:
        c = 0.5 * (lo + hi)
        e = np.full(3, thickness)
        e[axis] = 1.0 + thickness
        # 8 corners of the tube box
        corners = np.array([[sx, sy, sz] for sx in (-1, 1)
                            for sy in (-1, 1) for sz in (-1, 1)], np.float32)
        pts = c[None] + corners * e[None]
        pos_l.append(pts.astype(np.float32))
        nrm_l.append(np.tile([0, 1, 0], (8, 1)).astype(np.float32))
        tan_l.append(np.tile([1, 0, 0], (8, 1)).astype(np.float32))
        uv_l.append(np.zeros((8, 2), np.float32))
        # 12 tris covering the box (winding irrelevant for emissive debug:
        # emit both orientations so it's visible from everywhere)
        quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1),
                 (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]
        tris = []
        for (a, b, cc, d) in quads:
            tris += [(a, b, cc), (a, cc, d), (a, cc, b), (a, d, cc)]
        idx_l.append(np.asarray(tris, np.int32) + base)
        base += 8
    lod = GeometryLOD(
        positions=np.concatenate(pos_l), normals=np.concatenate(nrm_l),
        tangents=np.concatenate(tan_l), uvs=np.concatenate(uv_l),
        indices=np.concatenate(idx_l))
    return Mesh("EdgeTubeBox", [lod])


def _unlit_material(name: str, color) -> Material:
    m = Material(name=name)
    m.diffuse = np.zeros(3, np.float32)
    m.emissive_color = np.asarray(color, np.float32)
    m.emissive_intensity = 1.0
    m.roughness = 1.0
    return m


def light_gizmo_items(lights, materials: list[Material],
                      object_id_base: int = 100000) -> list[DrawItem]:
    """Light meshes (the reference draws gizmo spheres/cones for enabled
    lights with Unlit.hlsl; light transform scale drives gizmo size)."""
    items: list[DrawItem] = []
    gizmo_sphere = sphere(1.0, 12, 12)
    gizmo_cone = cone(1.0, 0.5, 16)
    for i, l in enumerate(lights):
        if not l.enabled or l.type == ELightType.DIRECTIONAL:
            continue
        mat = _unlit_material(f"__light_gizmo_{i}__", l.color)
        materials.append(mat)
        mid = len(materials) - 1
        if l.type == ELightType.POINT:
            mesh = gizmo_sphere
            rot = m3.quat_identity()
        else:
            mesh = gizmo_cone
            # cone apex up (+Y); orient -Y toward the spot direction
            rot = m3.quat_mul(l.rotation,
                              m3.quat_from_axis_angle((1, 0, 0), np.pi / 2))
        items.append(DrawItem(
            name=f"LightGizmo{i}", mesh=mesh,
            transform=m3.Transform(position=l.position.copy(), rotation=rot,
                                   scale=np.full(3, l.render_scale, np.float32)),
            material_id=mid, object_id=object_id_base + i))
    return items


def bounding_box_items(items: list[DrawItem], materials: list[Material],
                       color=(1.0, 0.85, 0.1),
                       object_id_base: int = 200000) -> list[DrawItem]:
    """Wireframe AABBs for every draw item (RenderBoundingBoxes analog,
    <= 512 per draw in the reference — here one edge-tube item per object)."""
    mat = _unlit_material("__bbox__", color)
    materials.append(mat)
    mid = len(materials) - 1
    tube = edge_tube_box()
    out = []
    for i, it in enumerate(items[:512]):
        c, e = it.mesh.local_aabb()
        tf = it.transform.copy()
        # local AABB -> local box transform composed with the item transform
        box_local = m3.Transform(position=c, scale=e)
        comp = tf.matrix() @ box_local.matrix()
        # decompose loosely: bake as a transform via matrix columns
        pos = comp[:3, 3]
        out.append(DrawItem(
            name=f"BBox{i}", mesh=tube,
            transform=_MatrixTransform(comp),
            material_id=mid, object_id=object_id_base + i))
        del pos
    return out


def vertex_axes_items(item: DrawItem, materials: list[Material],
                      axis_length: float = 0.12, thickness: float = 0.01,
                      max_vertices: int = 512,
                      object_id_base: int = 300000) -> list[DrawItem]:
    """Per-vertex T/B/N axis tubes for one selected object
    (RenderDebugVertexAxes, SceneRendering.cpp:2018; VertexDebug.hlsl draws
    instanced axis geometry at each vertex).

    One merged mesh per axis color (R=tangent, G=bitangent, B=normal)
    keeps it at 3 extra draw items instead of 3*V."""
    lod = item.mesh.lods[0]
    n = min(lod.positions.shape[0], max_vertices)
    pos = lod.positions[:n]
    nrm = lod.normals[:n]
    tan = lod.tangents[:n]
    bit = np.cross(nrm, tan)

    def tube_mesh(dirs: np.ndarray, name: str) -> Mesh:
        # a thin quad pair (cross section) along each axis direction —
        # emissive/unlit so winding & shading don't matter; both
        # orientations emitted like edge_tube_box
        d = dirs / np.maximum(np.linalg.norm(dirs, axis=1, keepdims=True),
                              1e-8)
        helper = np.where(np.abs(d[:, 1:2]) < 0.9,
                          np.array([[0.0, 1.0, 0.0]], np.float32),
                          np.array([[1.0, 0.0, 0.0]], np.float32))
        side = np.cross(d, helper)
        side /= np.maximum(np.linalg.norm(side, axis=1, keepdims=True), 1e-8)
        up = np.cross(d, side)
        p0 = pos
        p1 = pos + d * axis_length
        verts, tris = [], []
        for a, b in ((side, up), (up, side)):
            w = a * thickness
            quad = np.stack([p0 - w, p0 + w, p1 + w, p1 - w], axis=1)
            base = sum(v.shape[0] for v in verts)
            verts.append(quad.reshape(-1, 3))
            i0 = base + np.arange(n) * 4
            for (x, y, z) in ((0, 1, 2), (0, 2, 3), (0, 2, 1), (0, 3, 2)):
                tris.append(np.stack([i0 + x, i0 + y, i0 + z], axis=1))
        v = np.concatenate(verts).astype(np.float32)
        idx = np.concatenate(tris).astype(np.int32)
        glod = GeometryLOD(
            positions=v,
            normals=np.tile(np.float32([0, 1, 0]), (v.shape[0], 1)),
            tangents=np.tile(np.float32([1, 0, 0]), (v.shape[0], 1)),
            uvs=np.zeros((v.shape[0], 2), np.float32), indices=idx)
        return Mesh(name, [glod])

    axes = (("tan", tan, (1, 0.1, 0.1)), ("bit", bit, (0.1, 1, 0.1)),
            ("nrm", nrm, (0.1, 0.3, 1)))
    out = []
    for k, (name, dv, c) in enumerate(axes):
        mat = _unlit_material(f"__tbn_{name}_{item.name}__", c)
        materials.append(mat)
        out.append(DrawItem(
            name=f"TBN_{name}_{item.name}", mesh=tube_mesh(dv, f"tbn_{name}"),
            transform=item.transform.copy(), material_id=len(materials) - 1,
            object_id=object_id_base + k))
    return out


class _MatrixTransform(m3.Transform):
    """Transform wrapper carrying a precomposed matrix (AABB boxes compose
    object x box-local transforms that don't decompose into SRT cleanly)."""

    def __init__(self, mat: np.ndarray):
        super().__init__()
        self._mat = mat.astype(np.float32)

    def matrix(self) -> np.ndarray:
        return self._mat

    def copy(self):
        return _MatrixTransform(self._mat.copy())
