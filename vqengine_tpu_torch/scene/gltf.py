"""glTF 2.0 model import — counterpart of the reference's cgltf-based
AssetLoader::ImportGLTF (AssetLoader.cpp:1185): positions/normals/tangents/
uvs/indices per primitive, pbrMetallicRoughness material factors, node
transform flattening.

Pure python (json + struct + numpy); supports .gltf (external .bin) and
.glb containers, accessor component types 5120-5126, and the POSITION/
NORMAL/TANGENT/TEXCOORD_0 attributes the reference consumes.
"""
from __future__ import annotations

import json
import struct
from pathlib import Path

import numpy as np

from ..utils import math3d as m3
from .material import Material
from .mesh import GeometryLOD, Mesh

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
                "MAT2": 4, "MAT3": 9, "MAT4": 16}


def _load_container(path: Path) -> tuple[dict, list[bytes]]:
    data = path.read_bytes()
    if data[:4] == b"glTF":  # GLB
        _, _, _ = struct.unpack("<III", data[:12])
        pos = 12
        gltf = None
        buffers: list[bytes] = []
        while pos < len(data):
            clen, ctype = struct.unpack("<II", data[pos:pos + 8])
            chunk = data[pos + 8:pos + 8 + clen]
            pos += 8 + clen
            if ctype == 0x4E4F534A:  # JSON
                gltf = json.loads(chunk)
            elif ctype == 0x004E4942:  # BIN
                buffers.append(chunk)
        assert gltf is not None
        return gltf, buffers
    gltf = json.loads(data)
    buffers = []
    for buf in gltf.get("buffers", []):
        uri = buf.get("uri", "")
        if uri.startswith("data:"):
            import base64
            buffers.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            buffers.append((path.parent / uri).read_bytes())
    return gltf, buffers


def _read_accessor(gltf: dict, buffers: list[bytes], idx: int) -> np.ndarray:
    acc = gltf["accessors"][idx]
    view = gltf["bufferViews"][acc["bufferView"]]
    dtype = _COMPONENT_DTYPES[acc["componentType"]]
    ncomp = _TYPE_COUNTS[acc["type"]]
    count = acc["count"]
    buf = buffers[view.get("buffer", 0)]
    offset = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    stride = view.get("byteStride", 0)
    itemsize = np.dtype(dtype).itemsize * ncomp
    if stride and stride != itemsize:
        raw = np.frombuffer(buf, dtype=np.uint8,
                            count=stride * count, offset=offset)
        raw = raw.reshape(count, stride)[:, :itemsize].copy()
        out = raw.view(dtype).reshape(count, ncomp)
    else:
        out = np.frombuffer(buf, dtype=dtype, count=count * ncomp,
                            offset=offset).reshape(count, ncomp)
    return out


def _node_world_matrices(gltf: dict) -> dict[int, np.ndarray]:
    """Flatten the node hierarchy to per-node world matrices."""
    nodes = gltf.get("nodes", [])
    out: dict[int, np.ndarray] = {}

    def local(n) -> np.ndarray:
        if "matrix" in n:
            return np.array(n["matrix"], dtype=np.float32).reshape(4, 4).T
        t = m3.translation(n.get("translation", (0, 0, 0)))
        r = n.get("rotation", (0, 0, 0, 1))  # glTF xyzw
        rm = m3.quat_to_matrix(np.array([r[3], r[0], r[1], r[2]], np.float32))
        s = m3.scaling(np.array(n.get("scale", (1, 1, 1)), np.float32))
        return t @ rm @ s

    def walk(i, parent):
        w = parent @ local(nodes[i])
        out[i] = w
        for c in nodes[i].get("children", []):
            walk(c, w)

    scene = gltf.get("scenes", [{}])[gltf.get("scene", 0)]
    for root in scene.get("nodes", range(len(nodes))):
        walk(root, m3.identity4())
    return out


def _material_from_gltf(gltf: dict, idx: int | None) -> Material | None:
    if idx is None:
        return None
    gm = gltf.get("materials", [])[idx]
    pbr = gm.get("pbrMetallicRoughness", {})
    mat = Material(name=gm.get("name", f"gltf_mat_{idx}"))
    base = pbr.get("baseColorFactor", [1, 1, 1, 1])
    mat.diffuse = np.array(base[:3], dtype=np.float32)
    mat.alpha = float(base[3])
    mat.metalness = float(pbr.get("metallicFactor", 1.0))
    mat.roughness = float(pbr.get("roughnessFactor", 1.0))
    em = gm.get("emissiveFactor")
    if em:
        mat.emissive_color = np.array(em, dtype=np.float32)
        mat.emissive_intensity = 1.0
    return mat


def load_gltf_meshes(path: str | Path) -> list[tuple[Mesh, Material | None]]:
    """-> list of (Mesh, Material-or-None), node transforms baked in.

    glTF is right-handed +Y up with -Z forward; the engine is left-handed
    +Z forward. Conversion: negate Z (positions/normals), flip winding.
    """
    path = Path(path)
    gltf, buffers = _load_container(path)
    node_mats = _node_world_matrices(gltf)

    out: list[tuple[Mesh, Material | None]] = []
    for node_idx, world in node_mats.items():
        node = gltf["nodes"][node_idx]
        if "mesh" not in node:
            continue
        mesh_def = gltf["meshes"][node["mesh"]]
        nrm_mat = np.linalg.inv(world[:3, :3]).T
        for prim in mesh_def.get("primitives", []):
            attrs = prim["attributes"]
            pos = _read_accessor(gltf, buffers, attrs["POSITION"]).astype(np.float32)
            count = pos.shape[0]
            nrm = (_read_accessor(gltf, buffers, attrs["NORMAL"]).astype(np.float32)
                   if "NORMAL" in attrs else np.tile([0, 1, 0], (count, 1)).astype(np.float32))
            tan4 = (_read_accessor(gltf, buffers, attrs["TANGENT"]).astype(np.float32)
                    if "TANGENT" in attrs else None)
            if "TEXCOORD_0" in attrs:
                uv_raw = _read_accessor(gltf, buffers, attrs["TEXCOORD_0"])
                uv = uv_raw.astype(np.float32)
                if uv_raw.dtype != np.float32:  # normalized int uvs
                    uv = uv / np.iinfo(uv_raw.dtype).max
            else:
                uv = np.zeros((count, 2), np.float32)

            if "indices" in prim:
                idx = _read_accessor(gltf, buffers, prim["indices"]).reshape(-1, 3)
            else:
                idx = np.arange(count, dtype=np.uint32).reshape(-1, 3)
            idx = idx.astype(np.int32)

            # bake node transform
            pos = pos @ world[:3, :3].T + world[:3, 3]
            nrm = nrm @ nrm_mat.T
            tan = (tan4[:, :3] @ nrm_mat.T if tan4 is not None
                   else np.tile([1, 0, 0], (count, 1)).astype(np.float32))

            # RH -> LH: negate Z, flip winding so cross(e1,e2) stays outward
            pos = pos * np.array([1, 1, -1], dtype=np.float32)
            nrm = nrm * np.array([1, 1, -1], dtype=np.float32)
            tan = tan * np.array([1, 1, -1], dtype=np.float32)
            idx = idx[:, [0, 2, 1]]

            n = np.linalg.norm(nrm, axis=1, keepdims=True)
            nrm = np.where(n > 1e-9, nrm / np.maximum(n, 1e-12), [0, 1, 0])

            lod = GeometryLOD(positions=np.ascontiguousarray(pos),
                              normals=np.ascontiguousarray(nrm.astype(np.float32)),
                              tangents=np.ascontiguousarray(tan.astype(np.float32)),
                              uvs=np.ascontiguousarray(uv),
                              indices=np.ascontiguousarray(idx))
            mesh = Mesh(mesh_def.get("name", path.stem), [lod])
            out.append((mesh, _material_from_gltf(gltf, prim.get("material"))))
    return out
