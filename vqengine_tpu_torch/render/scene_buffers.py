"""Scene -> device buffers — the counterpart of the reference's static
buffer heaps + per-frame constant-buffer fills (Renderer.cpp:367-376 VB/IB
heaps; Batching.cpp:201-376 per-object CB arrays).

All mesh geometry in a scene merges into single SoA vertex/index tensors at
load time (the analog of UploadVertexAndIndexBufferHeaps, Renderer.cpp:1049).
Each *draw item* is one (game object, mesh) pair; instancing is implicit —
vertices carry their item id and the per-item matrix array is the instance
buffer. Per-frame, only the small [N,4,4] matrix tensors change.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..scene.camera import Camera, FCameraParameters
from ..scene.light import ELightType, Light
from ..scene.material import Material, pack_materials
from ..scene.mesh import Mesh
from ..utils import math3d as m3
from ..utils.log import warning


@dataclass
class DrawItem:
    """Host-side record of one renderable (object, mesh) pair."""
    name: str
    mesh: Mesh
    transform: m3.Transform
    material_id: int
    object_id: int
    lod: int = 0


@dataclass
class SceneBuffers:
    """Device-uploadable merged scene geometry (numpy; jnp.asarray at use)."""
    positions: np.ndarray       # [V, 3] local-space
    normals: np.ndarray         # [V, 3]
    tangents: np.ndarray        # [V, 3]
    uvs: np.ndarray             # [V, 2]
    item_of_vertex: np.ndarray  # [V] int32
    indices: np.ndarray         # [T, 3] int32 (merged vertex ids)
    tri_item: np.ndarray        # [T] int32
    tri_lod: np.ndarray         # [T] int32 — LOD level this triangle belongs to
    materials: np.ndarray       # [M, 20] packed material params
    item_material: np.ndarray   # [N] int32
    item_object: np.ndarray     # [N] int32
    item_num_lods: np.ndarray | None = None  # [N] int32
    items: list[DrawItem] = field(default_factory=list)
    # per-item static AABBs (local)
    aabb_center: np.ndarray | None = None  # [N, 3]
    aabb_extent: np.ndarray | None = None  # [N, 3]
    material_names: list[str] = field(default_factory=list)  # [M] (editor)
    # per-vertex geomorph targets (GeometryLOD.morph_mid); None when no
    # mesh in the scene tessellates — the renderer then skips the morph
    morph_mid: np.ndarray | None = None    # [V, 3]
    # quad-patch tessellation control data (Mesh.patches merged across
    # items); the per-frame amplifier (ops/tessellation.py) turns these
    # into raster triangles. Patch items' base-LOD triangles are moved to
    # the END of the tri-indexed arrays (rows >= num_tris_main) so the
    # main view renders patches while shadows keep the factor-1 geometry.
    patch_corners: np.ndarray | None = None   # [P, 4, 3]
    patch_normals: np.ndarray | None = None   # [P, 4, 3]
    patch_uvs: np.ndarray | None = None       # [P, 4, 2]
    patch_item: np.ndarray | None = None      # [P] int32
    patch_heightmap: np.ndarray | None = None  # [S, S]
    patch_disp_scale: float = 0.0
    patch_tess_scale: float = 100.0
    # TRI-domain material-driven tessellation (Material.tessellation_enabled,
    # the reference Material.h packed tess byte): base-LOD triangles of
    # such items promote to control patches, amplified per frame by
    # ops/tessellation.amplify_tri. Same suffix contract as quad patches.
    tpatch_corners: np.ndarray | None = None   # [P, 3, 3]
    tpatch_normals: np.ndarray | None = None   # [P, 3, 3]
    tpatch_uvs: np.ndarray | None = None       # [P, 3, 2]
    tpatch_item: np.ndarray | None = None      # [P] int32
    tpatch_heightmap: np.ndarray | None = None  # [S, S]
    tpatch_disp_scale: float = 0.0
    tpatch_tess_scale: float = 100.0
    num_tris_main: int | None = None           # None = all triangles

    @property
    def num_items(self) -> int:
        return len(self.items)

    def world_matrices(self) -> tuple[np.ndarray, np.ndarray]:
        """-> (world [N,4,4], normal [N,3,3]) from current item transforms.
        The per-frame CB fill (Batching.cpp:229-302)."""
        n = len(self.items)
        world = np.zeros((n, 4, 4), dtype=np.float32)
        nrm = np.zeros((n, 3, 3), dtype=np.float32)
        for i, it in enumerate(self.items):
            w = it.transform.matrix()
            world[i] = w
            nrm[i] = np.linalg.inv(w[:3, :3]).T
        return world, nrm


def build_scene_buffers(items: list[DrawItem], materials: list[Material],
                        all_lods: bool = True) -> SceneBuffers:
    """Merge every item's mesh (all LOD levels when all_lods) into single
    SoA buffers. Per-frame LOD selection masks triangles by tri_lod."""
    pos_l, nrm_l, tan_l, uv_l, iov_l, idx_l = [], [], [], [], [], []
    tri_item_l, tri_lod_l, morph_l = [], [], []
    any_morph = False
    item_mat = np.zeros(len(items), dtype=np.int32)
    item_obj = np.zeros(len(items), dtype=np.int32)
    item_nlod = np.ones(len(items), dtype=np.int32)
    aabb_c = np.zeros((len(items), 3), dtype=np.float32)
    aabb_e = np.zeros((len(items), 3), dtype=np.float32)
    vbase = 0
    for i, it in enumerate(items):
        lods = it.mesh.lods if all_lods else [it.mesh.lods[min(it.lod, it.mesh.num_lods - 1)]]
        item_nlod[i] = len(lods)
        for li, lod in enumerate(lods):
            pos_l.append(lod.positions)
            if lod.morph_mid is not None:
                any_morph = True
                morph_l.append(lod.morph_mid)
            else:
                morph_l.append(lod.positions)   # identity: never morphs
            nrm_l.append(lod.normals)
            tan_l.append(lod.tangents)
            uv_l.append(lod.uvs)
            iov_l.append(np.full(lod.num_vertices, i, dtype=np.int32))
            idx_l.append(lod.indices + vbase)
            tri_item_l.append(np.full(lod.num_triangles, i, dtype=np.int32))
            tri_lod_l.append(np.full(lod.num_triangles, li, dtype=np.int32))
            vbase += lod.num_vertices
        item_mat[i] = it.material_id
        item_obj[i] = it.object_id
        aabb_c[i], aabb_e[i] = it.mesh.local_aabb()

    if not items:
        # degenerate empty scene
        empty3 = np.zeros((0, 3), dtype=np.float32)
        return SceneBuffers(empty3, empty3, empty3,
                            np.zeros((0, 2), np.float32), np.zeros(0, np.int32),
                            np.zeros((0, 3), np.int32), np.zeros(0, np.int32),
                            np.zeros(0, np.int32),
                            pack_materials(materials), item_mat, item_obj,
                            item_nlod, [],
                            material_names=[m.name for m in materials])

    indices = np.concatenate(idx_l).astype(np.int32)
    tri_item = np.concatenate(tri_item_l)
    tri_lod = np.concatenate(tri_lod_l)

    # merge quad-patch control data; patch items' base-LOD triangles move
    # to the END so corner tables (main view) stop before them while the
    # shadow path still sees the factor-1 geometry
    pc_l, pn_l, puv_l, pitem_l = [], [], [], []
    hm, disp, tess = None, 0.0, 100.0
    for i, it in enumerate(items):
        ps = getattr(it.mesh, "patches", None)
        if ps is None:
            continue
        if len(pc_l) == 0:
            tess = ps.tess_scale
        pc_l.append(ps.corners)
        pn_l.append(ps.normals)
        puv_l.append(ps.uvs)
        pitem_l.append(np.full(ps.num_patches, i, np.int32))
        # one shared displacement field per scene (the Terrain heightmap):
        # amplify() applies it to EVERY patch, so a second set with a
        # different (or no) heightmap would silently displace wrong —
        # fail loudly instead (per-patch fields are the upgrade path)
        if ps.heightmap is not None:
            if hm is None:
                hm, disp, tess = ps.heightmap, ps.disp_scale, ps.tess_scale
            elif (hm is not ps.heightmap or disp != ps.disp_scale
                  or tess != ps.tess_scale):
                raise ValueError(
                    "multiple patch sets with differing heightmap/"
                    "disp_scale/tess_scale in one scene — the merged "
                    "displacement field is scene-global")
        elif hm is not None:
            raise ValueError(
                "mixing displaced and non-displaced patch sets in one "
                "scene — the merged displacement field is scene-global")
    # material-driven TRI-domain tessellation: items whose material
    # enables tessellation (Material.h packed tess byte) promote their
    # base-LOD triangles to control patches (ops/tessellation.amplify_tri)
    tpc_l, tpn_l, tpuv_l, tpitem_l = [], [], [], []
    thm, tdisp, ttess = None, 0.0, 100.0
    for i, it in enumerate(items):
        mat = materials[item_mat[i]] if item_mat[i] < len(materials) else None
        if (mat is None or not getattr(mat, "tessellation_enabled", False)
                or getattr(it.mesh, "patches", None) is not None):
            continue
        lod0 = it.mesh.lods[0]
        tpc_l.append(lod0.positions[lod0.indices].astype(np.float32))
        tpn_l.append(lod0.normals[lod0.indices].astype(np.float32))
        tpuv_l.append(lod0.uvs[lod0.indices].astype(np.float32))
        tpitem_l.append(np.full(lod0.num_triangles, i, np.int32))
        hm_i = getattr(mat, "height_map_image", None)
        disp_i = float(getattr(mat, "displacement", 0.0))
        tess_i = float(getattr(mat, "tessellation_scale", 100.0))
        if hm_i is not None:
            if thm is None:
                thm, tdisp, ttess = hm_i, disp_i, tess_i
            elif (thm is not hm_i or tdisp != disp_i or ttess != tess_i):
                raise ValueError(
                    "tessellated materials with differing heightmap/"
                    "displacement/tessellation_scale in one scene — the "
                    "merged displacement field is scene-global")
        elif thm is not None:
            raise ValueError(
                "mixing displaced and non-displaced tessellated materials "
                "in one scene — the merged displacement field is "
                "scene-global")
        elif len(tpitem_l) == 1:
            ttess = tess_i
        elif ttess != tess_i:
            raise ValueError(
                "tessellated materials with differing tessellation_scale "
                "in one scene — factors are scene-global (crack-free "
                "seams need shared edge factors)")

    num_tris_main = None
    if pc_l or tpc_l:
        is_amp_item = np.zeros(len(items), bool)
        if pc_l:
            is_amp_item[np.unique(np.concatenate(pitem_l))] = True
        if tpc_l:
            is_amp_item[np.unique(np.concatenate(tpitem_l))] = True
        tri_is_base = is_amp_item[tri_item]
        order = np.argsort(tri_is_base, kind="stable")
        indices, tri_item, tri_lod = (indices[order], tri_item[order],
                                      tri_lod[order])
        num_tris_main = int((~tri_is_base).sum())

    return SceneBuffers(
        morph_mid=(np.concatenate(morph_l).astype(np.float32)
                   if any_morph else None),
        positions=np.concatenate(pos_l),
        normals=np.concatenate(nrm_l),
        tangents=np.concatenate(tan_l),
        uvs=np.concatenate(uv_l),
        item_of_vertex=np.concatenate(iov_l),
        indices=indices,
        tri_item=tri_item,
        tri_lod=tri_lod,
        materials=pack_materials(materials),
        item_material=item_mat,
        item_object=item_obj,
        item_num_lods=item_nlod,
        items=items,
        aabb_center=aabb_c,
        aabb_extent=aabb_e,
        material_names=[m.name for m in materials],
        patch_corners=np.concatenate(pc_l) if pc_l else None,
        patch_normals=np.concatenate(pn_l) if pc_l else None,
        patch_uvs=np.concatenate(puv_l) if pc_l else None,
        patch_item=np.concatenate(pitem_l) if pc_l else None,
        patch_heightmap=hm,
        patch_disp_scale=disp,
        patch_tess_scale=tess,
        tpatch_corners=np.concatenate(tpc_l) if tpc_l else None,
        tpatch_normals=np.concatenate(tpn_l) if tpc_l else None,
        tpatch_uvs=np.concatenate(tpuv_l) if tpc_l else None,
        tpatch_item=np.concatenate(tpitem_l) if tpc_l else None,
        tpatch_heightmap=thm,
        tpatch_disp_scale=tdisp,
        tpatch_tess_scale=ttess,
        num_tris_main=num_tris_main,
    )


def split_transparent(buffers: SceneBuffers
                      ) -> tuple[SceneBuffers, SceneBuffers | None]:
    """Split merged buffers into (opaque, transparent-or-None) by material
    alpha — the reference's Model opaque/transparent mesh-ID split
    (Model.h:45-65). Vertex arrays are shared (triangles index into them);
    only the triangle-indexed arrays partition."""
    alpha = buffers.materials[buffers.item_material, 3]      # [N]
    item_transparent = alpha < 1.0
    if not item_transparent.any():
        return buffers, None
    tri_t = item_transparent[buffers.tri_item]               # [T]

    def subset(sel: np.ndarray, opaque: bool = False) -> SceneBuffers:
        ntm = None
        if opaque and buffers.num_tris_main is not None:
            # patch-base tris sit at the end; they stay a suffix of the
            # opaque subset (selection preserves order)
            main = np.zeros(len(sel), bool)
            main[: buffers.num_tris_main] = True
            ntm = int((sel & main).sum())
        return SceneBuffers(
            num_tris_main=ntm,
            patch_corners=buffers.patch_corners if opaque else None,
            patch_normals=buffers.patch_normals if opaque else None,
            patch_uvs=buffers.patch_uvs if opaque else None,
            patch_item=buffers.patch_item if opaque else None,
            patch_heightmap=buffers.patch_heightmap if opaque else None,
            patch_disp_scale=buffers.patch_disp_scale,
            patch_tess_scale=buffers.patch_tess_scale,
            tpatch_corners=buffers.tpatch_corners if opaque else None,
            tpatch_normals=buffers.tpatch_normals if opaque else None,
            tpatch_uvs=buffers.tpatch_uvs if opaque else None,
            tpatch_item=buffers.tpatch_item if opaque else None,
            tpatch_heightmap=buffers.tpatch_heightmap if opaque else None,
            tpatch_disp_scale=buffers.tpatch_disp_scale,
            tpatch_tess_scale=buffers.tpatch_tess_scale,
            positions=buffers.positions, normals=buffers.normals,
            tangents=buffers.tangents, uvs=buffers.uvs,
            item_of_vertex=buffers.item_of_vertex,
            indices=buffers.indices[sel],
            tri_item=buffers.tri_item[sel],
            tri_lod=buffers.tri_lod[sel],
            materials=buffers.materials,
            item_material=buffers.item_material,
            item_object=buffers.item_object,
            item_num_lods=buffers.item_num_lods,
            items=buffers.items,
            aabb_center=buffers.aabb_center,
            aabb_extent=buffers.aabb_extent,
            material_names=buffers.material_names,
            morph_mid=buffers.morph_mid,     # vertex-indexed: shared
        )

    return subset(~tri_t, opaque=True), subset(tri_t)


# ---------------------------------------------------------------------------
# scene representation -> draw items (the Scene::StartLoading analog,
# SceneLoading.cpp:100-420, with glTF fallback for missing model files)
# ---------------------------------------------------------------------------

def assemble_scene(rep, builtin_meshes: dict[str, Mesh],
                   material_lib: dict[str, Material],
                   gltf_loader=None, draw_light_gizmos: bool = False,
                   draw_bounding_boxes: bool = False,
                   draw_vertex_axes_of: int | None = None):
    """rep: FSceneRepresentation. Returns (SceneBuffers, cameras, lights)."""
    materials: list[Material] = [Material(name="__default__")]
    mat_index = {"__default__": 0}

    def material_id(name: str) -> int:
        if not name:
            return 0
        if name not in mat_index:
            mat = material_lib.get(name)
            if mat is None:
                warning(f"material '{name}' not found; using default")
                return 0
            mat_index[name] = len(materials)
            materials.append(mat)
        return mat_index[name]

    items: list[DrawItem] = []
    for oid, obj in enumerate(rep.objects):
        mesh = None
        mat_id = material_id(obj.model.material_name)
        if obj.model.builtin_mesh_name:
            mesh = builtin_meshes.get(obj.model.builtin_mesh_name)
            if mesh is None:
                warning(f"unknown builtin mesh '{obj.model.builtin_mesh_name}'")
        elif obj.model.path:
            if gltf_loader is not None:
                loaded = gltf_loader(obj.model.path)
                if loaded is not None:
                    # glTF models may carry their own materials
                    for sub_mesh, sub_mat in loaded:
                        mid = mat_id
                        if sub_mat is not None:
                            key = f"{obj.model.path}:{sub_mat.name}"
                            if key not in mat_index:
                                mat_index[key] = len(materials)
                                materials.append(sub_mat)
                            mid = mat_index[key]
                        items.append(DrawItem(
                            name=obj.model.name or sub_mesh.name,
                            mesh=sub_mesh, transform=obj.transform.copy(),
                            material_id=mid, object_id=oid))
                    continue
            warning(f"model '{obj.model.path}' unavailable; substituting Cube")
            mesh = builtin_meshes.get("Cube")
        if mesh is None:
            continue
        items.append(DrawItem(name=obj.model.name or mesh.name,
                              mesh=mesh, transform=obj.transform.copy(),
                              material_id=mat_id, object_id=oid))

    lights: list[Light] = rep.lights
    if draw_light_gizmos:
        from .debug_draw import light_gizmo_items
        items.extend(light_gizmo_items(lights, materials))
    if draw_bounding_boxes:
        from .debug_draw import bounding_box_items
        items.extend(bounding_box_items(items, materials))
    if draw_vertex_axes_of is not None and items:
        from .debug_draw import vertex_axes_items
        sel = items[min(draw_vertex_axes_of, len(items) - 1)]
        items.extend(vertex_axes_items(sel, materials))

    buffers = build_scene_buffers(items, materials)
    cameras = [Camera(p) for p in rep.cameras] or [Camera(FCameraParameters())]
    return buffers, cameras, lights
