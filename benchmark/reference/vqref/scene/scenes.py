"""Built-in scene behaviors — counterparts of Source/Scenes/*.cpp:
the typed Scene subclasses instantiated by name (VQEngine_Update.cpp:496-504)
that add procedural content and per-frame animation on top of the XML data.

- DefaultScene / SponzaScene: XML-driven only.
- EnvironmentMapUnitTestScene: 8x4 roughness/metallic sphere grid
  (EnvironmentMapUnitTestScene.cpp:49-104).
- StressTestScene: 16x2x12 randomized cube/sphere cloud (spacing 10,
  y-offset 25, scale ~2.5) + 8x10 gradient spheres + orbit/rotation
  animation and HDRI yaw rotation (StressTestScene.cpp:10-120,315-400).
- TerrainScene: heightmap-displaced detailed grid (the tessellation
  pipeline's displacement, baked at load since geometry amplification
  here is just more vertices).
"""
from __future__ import annotations

import numpy as np

from ..utils import math3d as m3
from .material import Material
from .serialization import (FGameObjectRepresentation, FModelRepresentation,
                            FSceneRepresentation)


def _grad_material(r: int, m: int, nr: int, nm: int,
                   color=(1.0, 1.0, 1.0)) -> Material:
    mat = Material(name=f"RoughnessMetallic[{r}][{m}]")
    mat.diffuse = np.asarray(color, np.float32)
    mat.roughness = r / max(nr - 1, 1)
    mat.metalness = m / max(nm - 1, 1)
    return mat


def _add_object(rep, mesh_name: str, pos, scale, material: str = "",
                rotation=None, name: str = "") -> None:
    obj = FGameObjectRepresentation()
    obj.transform = m3.Transform(
        position=np.asarray(pos, np.float32),
        rotation=rotation if rotation is not None else m3.quat_identity(),
        scale=np.asarray(scale, np.float32))
    obj.model = FModelRepresentation(builtin_mesh_name=mesh_name,
                                     material_name=material, name=name)
    rep.objects.append(obj)


# ---------------------------------------------------------------------------

def augment_environment_map_unit_test(rep: FSceneRepresentation,
                                      material_lib: dict) -> None:
    """EnvironmentMapUnitTestScene.cpp:49-104: an 8x4 grid of spheres with
    roughness on X and metallic on Y."""
    nr, nm = 8, 4
    for r in range(nr):
        for mtl in range(nm):
            mat = _grad_material(r, mtl, nr, nm)
            material_lib[mat.name] = mat
            s = 5.0
            x = -50.0 + r * (2 * s + 2.0)
            y = 50.0 + mtl * (2 * s + 2.0)
            _add_object(rep, "Sphere", (x, y, 0), (s, s, s), mat.name,
                        name=f"GradientSphere[{r}][{mtl}]")


_STRESS_COLORS = np.asarray([
    [0.90, 0.90, 0.90], [0.40, 0.15, 0.00], [0.00, 0.05, 0.65],
    [0.05, 0.05, 0.05], [0.15, 0.15, 0.15],
], np.float32)  # StressTestScene.cpp:34-41


class StressTestAnimation:
    """Orbit + rotation animation state (StressTestScene.cpp:45-84,
    randomized axes/speeds per generated object)."""

    def __init__(self, object_names: list[str], rng: np.random.Generator):
        n = len(object_names)
        self.names = set(object_names)
        axes = rng.normal(size=(n, 3)).astype(np.float32)
        self.rot_axes = axes / np.linalg.norm(axes, axis=1, keepdims=True)
        self.rot_speeds = rng.uniform(0.0, 400.0, n).astype(np.float32)
        axes2 = rng.normal(size=(n, 3)).astype(np.float32)
        self.orbit_axes = axes2 / np.linalg.norm(axes2, axis=1, keepdims=True)
        self.orbit_speeds = rng.uniform(0.1, 0.8, n).astype(np.float32)
        self.orbit_point = np.zeros(3, np.float32)
        self.hdri_yaw = 0.0

    def __call__(self, engine, dt: float) -> None:
        # HDRI rotation (StressTestScene::UpdateScene yaw slider)
        self.hdri_yaw = (self.hdri_yaw + 0.01 * dt) % 1.0
        items = engine.scene_buffers.items
        i = 0
        for it in items:
            if it.name not in self.names:
                continue
            tf = it.transform
            # rotate around own axis
            q = m3.quat_from_axis_angle(self.rot_axes[i % len(self.rot_axes)],
                                        np.deg2rad(self.rot_speeds[i % len(self.rot_speeds)]) * dt)
            tf.rotation = m3.quat_mul(q, tf.rotation)
            # orbit around the origin point
            oq = m3.quat_from_axis_angle(self.orbit_axes[i % len(self.orbit_axes)],
                                         self.orbit_speeds[i % len(self.orbit_speeds)] * dt)
            tf.position = m3.quat_rotate(oq, tf.position - self.orbit_point) + self.orbit_point
            i += 1


def augment_stress_test(rep: FSceneRepresentation, material_lib: dict,
                        dims=(16, 2, 12), seed: int = 17):
    """StressTestScene.cpp:315-400: the randomized object cloud + gradient
    spheres. Returns the animation hook."""
    rng = np.random.default_rng(seed)
    nr, nm = 8, 10

    # material cloud
    for r in range(nr):
        for mtl in range(nm):
            for c in range(len(_STRESS_COLORS)):
                mat = _grad_material(r, mtl, nr, nm, _STRESS_COLORS[c])
                mat.name = f"InstanceCloud[{r}][{mtl}][{c}]"
                material_lib[mat.name] = mat

    dx, dy, dz = dims
    distance, y_off = 10.0, 25.0
    base_scale, neg_max = 2.5, 2.5 / 3.0
    names = []
    idx = 0
    for x in range(-dx // 2, (dx - 1) // 2 + 1):
        for y in range(-dy // 2, (dy - 1) // 2 + 1):
            for z in range(-dz // 2, (dz - 1) // 2 + 1):
                pos = (x * distance,
                       y_off + y * distance + rng.uniform(-4, 4),
                       z * distance)
                is_cube = rng.integers(0, 2) == 0
                if is_cube:
                    scale = base_scale - rng.uniform(0, neg_max, 3)
                else:
                    scale = np.full(3, base_scale - rng.uniform(0, neg_max))
                rot = m3.quat_mul(
                    m3.quat_from_axis_angle((1, 0, 0),
                                            np.deg2rad(rng.uniform(-15, 15))),
                    m3.quat_from_axis_angle((0, 1, 0),
                                            np.deg2rad(rng.uniform(0, 360))))
                mat = f"InstanceCloud[{rng.integers(0, nr)}]" \
                      f"[{rng.integers(0, nm)}][{rng.integers(0, 5)}]"
                name = f"StressObj{idx}"
                _add_object(rep, "Cube" if is_cube else "Sphere",
                            pos, scale, mat, rotation=rot, name=name)
                names.append(name)
                idx += 1

    # gradient spheres at y=200 (StressTestScene.cpp:373-400)
    for r in range(nr):
        for mtl in range(nm):
            mat = _grad_material(r, mtl, nr, nm)
            material_lib[mat.name] = mat
            s = 5.0
            _add_object(rep, "Sphere",
                        (-50.0 + r * (2 * s + 2), 200.0 + mtl * (2 * s + 2), 0),
                        (s, s, s), mat.name, name=f"GradSphere[{r}][{mtl}]")

    # material-driven TRI-domain tessellation exercise (Material.h's
    # packed tess byte + Tessellation.hlsl's displacement path): a
    # displaced rock — an ordinary cube whose MATERIAL enables
    # tessellation, promoted to control patches by scene assembly
    rock = Material(name="TessRock")
    rock.diffuse = np.asarray([0.46, 0.41, 0.35], np.float32)
    rock.roughness = 0.92
    rock.tessellation_enabled = True
    rock.tessellation_scale = 600.0
    rock.displacement = 1.1
    from .texture_manager import noise_texture
    rock.height_map_image = noise_texture(64, base=0.35, amp=0.35,
                                          seed=17)[..., 0]
    material_lib[rock.name] = rock
    _add_object(rep, "Cube", (0.0, 6.0, -70.0), (8.0, 8.0, 8.0),
                "TessRock", name="TessRock0")

    # a default camera outside the cloud looking back at it (the reference
    # scene positions its camera in the XML; without one the default pose
    # sits inside the instance cloud)
    if not rep.cameras:
        from .camera import FCameraParameters
        cam = FCameraParameters()
        cam.position = np.array([0.0, 60.0, -160.0], np.float32)
        cam.pitch_deg = 5.0
        cam.yaw_deg = 0.0
        cam.far_z = 3000.0
        rep.cameras.append(cam)

    return StressTestAnimation(names, rng)


def _terrain_heightmap(n: int = 256, seed: int = 3) -> np.ndarray:
    """Procedural fBm heightmap (the reference Terrain scene displaces with
    a heightmap texture via the tessellation pipeline)."""
    rng = np.random.default_rng(seed)
    h = np.zeros((n, n), np.float32)
    amp, freq = 1.0, 4
    for _ in range(5):
        g = rng.normal(size=(freq + 1, freq + 1)).astype(np.float32)
        ys = np.linspace(0, freq, n)
        xs = np.linspace(0, freq, n)
        y0 = np.floor(ys).astype(int)
        x0 = np.floor(xs).astype(int)
        fy = (ys - y0)[:, None]
        fx = (xs - x0)[None, :]
        sy = fy * fy * (3 - 2 * fy)
        sx = fx * fx * (3 - 2 * fx)
        v = (g[y0][:, x0] * (1 - sy) * (1 - sx)
             + g[y0][:, np.minimum(x0 + 1, freq)] * (1 - sy) * sx
             + g[np.minimum(y0 + 1, freq)][:, x0] * sy * (1 - sx)
             + g[np.minimum(y0 + 1, freq)][:, np.minimum(x0 + 1, freq)] * sy * sx)
        h += amp * v
        amp *= 0.5
        freq *= 2
    h -= h.min()
    h /= max(h.max(), 1e-6)
    return h


def build_terrain_mesh(size: float = 1000.0, height: float = 60.0,
                       res: int = 400, num_lods: int = 4):
    """Displaced grid standing in for the tessellated heightmap terrain
    (TerrainScene + Tessellation.hlsl displacement)."""
    from . import mesh as meshmod
    hm = _terrain_heightmap(res)
    base = meshmod.grid(size, size, res, res, num_lods=num_lods)
    for lod in base.lods:
        n = int(np.sqrt(lod.num_vertices))
        u = ((lod.positions[:, 0] / size) + 0.5) * (res - 1)
        v = ((lod.positions[:, 2] / size) + 0.5) * (res - 1)
        ui = np.clip(u.astype(int), 0, res - 1)
        vi = np.clip(v.astype(int), 0, res - 1)
        lod.positions[:, 1] = hm[vi, ui] * height
        del n
    # recompute normals from the heightmap gradient on LOD0 spacing
    for lod in base.lods:
        u = np.clip((((lod.positions[:, 0] / size) + 0.5) * (res - 1)).astype(int), 1, res - 2)
        v = np.clip((((lod.positions[:, 2] / size) + 0.5) * (res - 1)).astype(int), 1, res - 2)
        dhdx = (hm[v, u + 1] - hm[v, u - 1]) * height / (2 * size / res)
        dhdz = (hm[v + 1, u] - hm[v - 1, u]) * height / (2 * size / res)
        nrm = np.stack([-dhdx, np.ones_like(dhdx), -dhdz], -1)
        lod.normals[:] = nrm / np.linalg.norm(nrm, axis=1, keepdims=True)
    base.name = "Terrain"
    return base


def _add_skirt(lod, drop: float):
    """Append a dropped-border 'skirt' ring to a row-major grid patch —
    the standard crack-hider between adjacent terrain patches at different
    tessellation levels (the reference avoids cracks with matching HS edge
    factors; quantized per-patch levels need the skirt instead)."""
    nv = lod.positions.shape[0]
    n = int(round(np.sqrt(nv)))
    assert n * n == nv, "skirt expects a square grid patch"
    idx = np.arange(nv).reshape(n, n)
    # border ring walked in order (top row, right col, bottom row reversed,
    # left col reversed) -> consecutive pairs are border edges
    ring = np.concatenate([idx[0, :-1], idx[:-1, -1],
                           idx[-1, :0:-1], idx[:0:-1, 0]])
    rn = ring.shape[0]
    dup = lod.positions[ring].copy()
    dup[:, 1] -= drop
    a = ring
    b = np.roll(ring, -1)
    a2 = nv + np.arange(rn)
    b2 = nv + (np.arange(rn) + 1) % rn
    quads = np.stack([a, b, b2, a, b2, a2], axis=1).reshape(-1, 3)
    quads_back = quads[:, ::-1]               # double-sided: winding-proof
    from .mesh import GeometryLOD
    morph = None
    if lod.morph_mid is not None:
        # skirt copies morph in lockstep with their border vertex (same
        # drop) so no crack opens between the edge and its skirt mid-morph
        mdup = lod.morph_mid[ring].copy()
        mdup[:, 1] -= drop
        morph = np.concatenate([lod.morph_mid, mdup]).astype(np.float32)
    return GeometryLOD(
        positions=np.concatenate([lod.positions, dup]).astype(np.float32),
        normals=np.concatenate([lod.normals, lod.normals[ring]]).astype(np.float32),
        tangents=np.concatenate([lod.tangents, lod.tangents[ring]]).astype(np.float32),
        uvs=np.concatenate([lod.uvs, lod.uvs[ring]]).astype(np.float32),
        indices=np.concatenate([lod.indices, quads, quads_back]).astype(np.int32),
        morph_mid=morph)


_HEIGHTMAP_CACHE: dict = {}


def _cached_heightmap(n: int, seed: int = 3) -> np.ndarray:
    key = (n, seed)
    if key not in _HEIGHTMAP_CACHE:
        _HEIGHTMAP_CACHE[key] = _terrain_heightmap(n, seed)
    return _HEIGHTMAP_CACHE[key]


def _displace_by_heightmap(lod, hm: np.ndarray, size: float, height: float):
    res = hm.shape[0]
    u = np.clip((((lod.positions[:, 0] / size) + 0.5) * (res - 1)), 0, res - 1)
    v = np.clip((((lod.positions[:, 2] / size) + 0.5) * (res - 1)), 0, res - 1)
    ui, vi = u.astype(int), v.astype(int)
    lod.positions[:, 1] = hm[vi, ui] * height
    uc = np.clip(ui, 1, res - 2)
    vc = np.clip(vi, 1, res - 2)
    dhdx = (hm[vc, uc + 1] - hm[vc, uc - 1]) * height / (2 * size / res)
    dhdz = (hm[vc + 1, uc] - hm[vc - 1, uc]) * height / (2 * size / res)
    nrm = np.stack([-dhdx, np.ones_like(dhdx), -dhdz], -1)
    lod.normals[:] = nrm / np.linalg.norm(nrm, axis=1, keepdims=True)


def build_terrain_patch(px: int, pz: int, patches: int = 6,
                        size: float = 1000.0, height: float = 60.0,
                        res: int = 400, num_lods: int = 3):
    """One terrain patch as a multi-LOD mesh — the adaptive-tessellation
    unit. Each patch carries `num_lods` subdivision levels; the per-item
    projected-AABB LOD select (ops/culling.py) picks the level per frame,
    which is Tessellation.hlsl's distance-based tess factors quantized to
    discrete levels and chosen device-side. Patch borders carry skirts so
    neighboring patches at different levels don't show cracks."""
    from . import mesh as meshmod
    hm = _cached_heightmap(res)
    psize = size / patches
    # power-of-two cell counts so LOD levels halve EXACTLY: the even-vertex
    # subset of level l IS level l+1's grid, which makes the geomorph
    # target of a fully morphed level equal the next level bit-for-bit
    cells = 64
    while cells > 8 and cells > res // patches:
        cells //= 2
    base = meshmod.grid_exact_halving(psize, psize, cells=cells,
                                      num_lods=num_lods)
    x_off = (px + 0.5) / patches * size - size / 2
    z_off = (pz + 0.5) / patches * size - size / 2
    cell = psize / cells
    new_lods = []
    for li, lod in enumerate(base.lods):
        lod.positions[:, 0] += x_off
        lod.positions[:, 2] += z_off
        _displace_by_heightmap(lod, hm, size, height)
        # geomorph targets from the DISPLACED grid (the on-device
        # continuous-tessellation morph table; coarsest level never morphs)
        n_side = max(cells >> li, 1) + 1
        if li < len(base.lods) - 1:
            lod.morph_mid = meshmod.grid_geomorph_mids(
                lod.positions, n_side, n_side)
        new_lods.append(_add_skirt(lod, drop=max(3.0 * cell, 0.04 * height)))
    base.lods = new_lods
    base.name = f"TerrainPatch[{px}][{pz}]"
    return base


def augment_terrain(rep: FSceneRepresentation, material_lib: dict,
                    builtin_meshes, patches: int = 24,
                    size: float = 1000.0, height: float = 60.0,
                    tess_scale: float = 250.0) -> None:
    """Adaptive-tessellation terrain through the QUAD-PATCH pipeline
    (ops/tessellation.py): a patches x patches control grid whose
    per-frame fractional-odd factors come from per-edge view distance and
    whose displacement samples the heightmap in the amplifier — the
    counterpart of the reference's HS/DS heightmap tessellation
    (Tessellation.hlsl:1-675, TerrainScene). Per-patch frustum culling
    happens before amplification (the HS zero-factor cull)."""
    from . import mesh as meshmod
    mat = Material(name="TerrainMat")
    mat.diffuse = np.asarray([0.35, 0.3, 0.22], np.float32)
    mat.roughness = 0.9
    mat.tessellation_enabled = True
    material_lib[mat.name] = mat
    if "TerrainPatches" not in builtin_meshes._builders:
        builtin_meshes._builders["TerrainPatches"] = (
            lambda: meshmod.patch_grid(
                size, size, patches, patches,
                heightmap=_cached_heightmap(256), disp_scale=height,
                tess_scale=tess_scale, name="TerrainPatches"))
    _add_object(rep, "TerrainPatches", (0, -20, 0), (1, 1, 1), "TerrainMat",
                name="TerrainPatches")


def augment_sponza_substitute(rep: FSceneRepresentation, material_lib: dict,
                              data_dirs=()) -> None:
    """When the Sponza glTF isn't on disk (the reference downloads it via
    a script), stand in a procedural colonnade hall of comparable structure
    (floor, walls, two column rows, upper gallery) so the Sponza config
    still exercises the full pipeline."""
    from pathlib import Path
    for obj in rep.objects:
        if obj.model.path and any(
                (Path(base).parent / obj.model.path).is_file()
                for base in data_dirs or []):
            return  # real model present; no substitute needed
    # drop the unresolvable gltf objects; build the hall
    rep.objects = [o for o in rep.objects if not o.model.path]

    mats = {
        "SponzaFloor": ((0.45, 0.40, 0.35), 0.75, 0.0),
        "SponzaWall": ((0.55, 0.48, 0.40), 0.85, 0.0),
        "SponzaColumn": ((0.50, 0.46, 0.42), 0.6, 0.0),
        "SponzaTrim": ((0.35, 0.15, 0.12), 0.4, 0.0),
        "SponzaBrass": ((0.8, 0.6, 0.25), 0.25, 1.0),
    }
    for name, (dif, rough, metal) in mats.items():
        m = Material(name=name)
        m.diffuse = np.asarray(dif, np.float32)
        m.roughness = rough
        m.metalness = metal
        material_lib[name] = m

    # real-Sponza world scale: the XML camera sits at (700, 170, -50)
    # looking down -X, so the atrium must extend past |x| ~ 900
    L, W_, H_ = 2000.0, 600.0, 360.0
    _add_object(rep, "Cube", (0, -10, 0), (L / 2, 10, W_ / 2), "SponzaFloor", name="Floor")
    _add_object(rep, "Cube", (0, H_ + 10, 0), (L / 2, 10, W_ / 2), "SponzaWall", name="Ceiling")
    for sz in (-1, 1):
        _add_object(rep, "Cube", (0, H_ / 2, sz * W_ / 2), (L / 2, H_ / 2, 10),
                    "SponzaWall", name=f"WallZ{sz}")
    for sx in (-1, 1):
        _add_object(rep, "Cube", (sx * L / 2, H_ / 2, 0), (10, H_ / 2, W_ / 2),
                    "SponzaWall", name=f"WallX{sx}")
    # column rows with plinths and capitals (two colonnades)
    n_cols = 12
    col_h = 110.0
    for i in range(n_cols):
        x = -L / 2 + (i + 0.5) * (L / n_cols)
        for sz in (-1, 1):
            z = sz * (W_ / 2 - 110.0)
            _add_object(rep, "Cube", (x, 10, z), (24, 10, 24),
                        "SponzaTrim", name=f"Plinth{i}{sz}")
            _add_object(rep, "Cylinder", (x, 20 + col_h / 2, z),
                        (15, col_h / 6, 15), "SponzaColumn",
                        name=f"Column{i}{sz}")
            _add_object(rep, "Cube", (x, 30 + col_h, z), (26, 10, 26),
                        "SponzaTrim", name=f"Capital{i}{sz}")
    # upper gallery ledges
    for sz in (-1, 1):
        _add_object(rep, "Cube", (0, 50 + col_h, sz * (W_ / 2 - 110.0)),
                    (L / 2, 10, 55), "SponzaFloor", name=f"Gallery{sz}")
    # centerpiece spheres (the lion-head stand-ins)
    for i, x in enumerate((-300.0, 0.0, 300.0)):
        _add_object(rep, "Sphere", (x, 50.0, 0), (40, 40, 40),
                    "SponzaBrass", name=f"Centerpiece{i}")


# registry: scene name -> augmentation; returns optional update hook
def augment_scene(name: str, rep: FSceneRepresentation, material_lib: dict,
                  builtin_meshes, data_dirs=()):
    if name == "EnvironmentMapUnitTest":
        augment_environment_map_unit_test(rep, material_lib)
        return None
    if name == "StressTest":
        return augment_stress_test(rep, material_lib)
    if name == "Terrain":
        augment_terrain(rep, material_lib, builtin_meshes)
        return None
    if name == "Sponza":
        augment_sponza_substitute(rep, material_lib, data_dirs)
        return None
    return None
