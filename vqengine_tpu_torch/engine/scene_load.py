"""Host-side scene load: data directories, the material library, level
XML parse, typed-scene augmentation and assembly into SceneBuffers, the
scene's textures, and the decode of the scene's environment map; and the
textured Sponza stress scene (sponza_stress).

Counterpart of the host half of ``vqengine_tpu/engine/engine.py``
(find_data_dirs, _load_material_lib, _resolve_material_textures,
_load_scene_host, _decode_environment) and of ``bench.py``'s scene
functions, on the port's own copies of the JAX package's numpy host
modules (scene, utils, render.scene_buffers, engine.settings), so it
imports neither jax nor the JAX package. The textures are packed into
host (CPU) tensors; VQRendererTorch.load_scene moves them to its device.
"""
from __future__ import annotations

import math
import tempfile
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from ..ops.ibl import procedural_sky_equirect
from ..render.scene_buffers import SceneBuffers, assemble_scene
from ..scene.material import Material
from ..scene.mesh import build_builtin_meshes
from ..scene.scenes import augment_scene
from ..scene.serialization import parse_material_file, parse_scene_file
from ..scene.texture_manager import (ETextureState, TextureManager,
                                     checkerboard, checkerboard_grayscale)
from ..utils import log
from ..utils.image_io import read_hdr
from .settings import load_environment_map_presets

REPO_DATA = Path(__file__).resolve().parent.parent.parent / "Data"
# Sponza with two of its own materials made translucent (load_scene's
# material_alpha): the 24 columns overlap down the hall, so both layers of
# the transparent pass carry pixels
SPONZA_TRANSLUCENT = {"SponzaColumn": 0.4, "SponzaBrass": 0.5}


def find_data_dirs() -> list[Path]:
    """Data roots in priority order: ./Data, then the repository's."""
    seen, out = set(), []
    for d in ("Data", REPO_DATA):
        p = Path(d).resolve()
        if p in seen:
            continue
        if (p / "Levels").is_dir() or (p / "EngineSettings.ini").is_file():
            seen.add(p)
            out.append(p)
    return out


def load_material_lib(data_dirs: list[Path],
                      tm: TextureManager | None = None) -> tuple[dict, dict]:
    """-> (name -> Material, name -> {slot: texture path}); earlier data
    dirs win. The procedural checkerboard materials take texture ids 0 and
    1, their images registered in `tm` when given (the engine's texture
    manager creates them first)."""
    lib, tex_paths = {}, {}
    for d in reversed(data_dirs):
        mat_dir = d / "Materials"
        if not mat_dir.is_dir():
            continue
        for xml in sorted(mat_dir.glob("*.xml")):
            for mat, paths in parse_material_file(xml):
                lib[mat.name] = mat
                tex_paths[mat.name] = paths
    # the procedural checkerboard materials; texture ids 0 and 1 are the
    # ones the reference's texture manager hands their images first
    for tid, (name, key, image) in enumerate((
            ("Checkerboard", "proc:checkerboard", checkerboard),
            ("Checkerboard_Grayscale", "proc:checkerboard_gray",
             checkerboard_grayscale))):
        m = Material(name=name)
        m.textures["diffuse"] = (tm.create_from_array(key, image())
                                 if tm is not None else tid)
        lib[name] = m
    return lib, tex_paths


def resolve_material_textures(tm: TextureManager, lib: dict, tex_paths: dict,
                              used: set, data_dirs: list[Path]) -> None:
    """The used materials' texture files queued on `tm` (the engine's
    _resolve_material_textures): a file that is missing or fails to decode
    drops its slot; then the normal, roughness and metallic maps fuse into
    one combined aux map, and diffuse and aux pair into shared rows."""
    bases = [d.parent for d in data_dirs]
    queued = []
    for name in used:
        mat = lib.get(name)
        paths = tex_paths.get(name, {})
        if mat is None or not paths:
            continue
        for slot, path in paths.items():
            tid = tm.create_from_file(path, search_dirs=bases)
            mat.textures[slot] = tid
            queued.append((mat, slot, tid))
    tm.wait_all()
    dropped = 0
    for mat, slot, tid in queued:
        if tm.state(tid) != ETextureState.READY:
            mat.textures.pop(slot, None)
            dropped += 1
    if queued:
        log.info(f"textures: {len(queued) - dropped} loaded, {dropped} "
                 f"missing (slots dropped)")
    mats = [lib[n] for n in used if n in lib]
    tm.combine_aux_maps(mats)
    tm.combine_pair_quads(mats)


def any_textured(lib: dict, used: set, buffers: SceneBuffers) -> bool:
    """Whether the scene samples a texture (the engine's test: a used
    material, or an item's material row, with a diffuse map or a combined
    aux map)."""
    return any(m.pack()[15] > 0 or m.combined_aux >= 0
               for m in (lib.get(n) for n in used) if m is not None) or any(
        it.material_id and (buffers.materials[it.material_id][15] > 0
                            or buffers.materials[it.material_id][29] >= 0)
        for it in buffers.items)


def load_environment_presets(data_dirs: list[Path]) -> dict:
    """EnvironmentMaps.ini presets of every data dir; earlier dirs win."""
    presets: dict = {}
    for d in reversed(data_dirs):
        presets.update(load_environment_map_presets(d))
    return presets


# the equirect's largest width (8K HDRIs are overkill for 128px cubemaps)
MAX_EQUIRECT_WIDTH = 2048


def decode_environment(rep, data_dirs: list[Path],
                       presets: dict) -> tuple[np.ndarray | None, float]:
    """Host-side env-map decode, as the engine's _decode_environment: preset
    -> HDRI file -> equirect [He, We, 3] f32; a missing file or an unknown
    preset falls back to the procedural sky (shaped by the preset's
    SunPitch, SunYaw and Turbidity). -> (equirect, or None when the scene
    wants no environment; the preset's MaxCLL)."""
    if not rep.env_map_preset and not rep.env_map_path:
        return None, 0.0
    equirect = None
    path = rep.env_map_path
    preset = {}
    if rep.env_map_preset and rep.env_map_preset in presets:
        preset = presets[rep.env_map_preset]
        path = preset.get("Path", "")
    max_cll = float(preset.get("MaxCLL", 0.0))
    if path:
        for base in [d.parent for d in data_dirs] + [Path(".")]:
            p = Path(base) / path
            if p.is_file():
                try:
                    equirect = read_hdr(p)
                    log.info(f"loaded HDRI {p} {equirect.shape}")
                    break
                except Exception as e:  # noqa: BLE001
                    log.warning(f"HDRI load failed for {p}: {e}")
    if equirect is None:
        # procedural presets (Data/EnvironmentMaps.ini SunPitch/SunYaw)
        # parameterize the sky instead of naming a file
        kw = {}
        if "SunPitch" in preset or "SunYaw" in preset:
            pitch = math.radians(float(preset.get("SunPitch", 45.0)))
            yaw = math.radians(float(preset.get("SunYaw", 30.0)))
            kw["sun_dir"] = (math.cos(pitch) * math.sin(yaw),
                             math.sin(pitch),
                             math.cos(pitch) * math.cos(yaw))
            if "Turbidity" in preset:
                # hazier sky: dimmer disc, brighter horizon
                t = float(preset["Turbidity"])
                kw["sun_intensity"] = 50.0 / max(t / 2.5, 1.0)
        else:
            log.warning(f"environment '{rep.env_map_preset or path}' "
                        f"not found; using procedural sky")
        equirect = procedural_sky_equirect(512, 256, **kw)
    if equirect.shape[1] > MAX_EQUIRECT_WIDTH:
        step = equirect.shape[1] // MAX_EQUIRECT_WIDTH
        equirect = equirect[::step, ::step]
    return equirect, max_cll


@dataclass
class LoadedScene:
    name: str
    buffers: SceneBuffers
    cameras: list
    lights: list
    wants_environment: bool
    # the scene's textures (ops.texture.PackedTextures on the CPU), or None
    # when no material samples one
    textures: object | None
    has_shadow_casters: bool
    # the decoded environment [He, We, 3] f32 (None: the scene has none)
    # and its preset's MaxCLL (nits; for the HDR10 encode)
    equirect: np.ndarray | None = None
    env_max_cll: float = 0.0


def load_scene(name: str, width: int, height: int,
               draw_light_gizmos: bool = True,
               material_alpha: dict | None = None) -> LoadedScene:
    """Parse Data/Levels/<name>.xml and assemble it; cameras get the
    width/height aspect. material_alpha {material name: alpha} sets those
    materials' alpha before assembly (a translucent variant of the level:
    alpha < 1 puts their items into the transparent pass)."""
    data_dirs = find_data_dirs()
    path = next((d / "Levels" / f"{name}.xml" for d in data_dirs
                 if (d / "Levels" / f"{name}.xml").is_file()), None)
    if path is None:
        raise FileNotFoundError(f"scene '{name}' not found in {data_dirs}")
    tm = TextureManager()
    lib, tex_paths = load_material_lib(data_dirs, tm)
    rep = parse_scene_file(path)
    meshes = build_builtin_meshes()
    augment_scene(rep.name, rep, lib, meshes, data_dirs=data_dirs)
    for mname, alpha in (material_alpha or {}).items():
        lib[mname].alpha = float(alpha)
    used = {o.model.material_name for o in rep.objects if o.model.material_name}
    resolve_material_textures(tm, lib, tex_paths, used, data_dirs)
    buffers, cameras, lights = assemble_scene(
        rep, meshes, lib, draw_light_gizmos=draw_light_gizmos)
    for c in cameras:
        c.aspect = width / max(1, height)
    textures = (tm.build_device_arrays_packed(torch.device("cpu"))
                if any_textured(lib, used, buffers) else None)
    has_casters = any(l.enabled and l.casts_shadows for l in lights)
    equirect, max_cll = decode_environment(
        rep, data_dirs, load_environment_presets(data_dirs))
    log.info(f"scene '{rep.name}': {buffers.indices.shape[0]} tris, "
             f"{len(buffers.items)} items")
    return LoadedScene(name=rep.name, buffers=buffers, cameras=cameras,
                       lights=lights,
                       wants_environment=bool(rep.env_map_preset
                                              or rep.env_map_path),
                       textures=textures,
                       has_shadow_casters=has_casters,
                       equirect=equirect, env_max_cll=max_cll)


# ---------------------------------------------------------------------------
# the textured Sponza stress scene (bench.py's frame)
# ---------------------------------------------------------------------------

def stress_textures(size: int = 512) -> tuple[TextureManager, dict]:
    """Procedural material maps (the reference's Sponza textures are not
    shipped): brick and stone diffuse, bump normal, noise roughness, at
    size^2 (bench.build_textures) -> (manager, name -> texture id)."""
    from ..scene.texture_manager import brick, noise_texture, normal_from_height
    tm = TextureManager(size=size)
    tm.create_from_array("brick", brick(size))
    tm.create_from_array("stone", checkerboard(
        size, 8, (0.62, 0.58, 0.52), (0.48, 0.45, 0.42)))
    tm.create_from_array("marble", checkerboard(
        size, 4, (0.8, 0.78, 0.72), (0.7, 0.68, 0.65)))
    h = noise_texture(size, seed=21)
    tm.create_from_array("bump_n", normal_from_height(h, 1.6))
    tm.create_from_array("rough", noise_texture(size, base=0.6, amp=0.3))
    ids = {k: tm._by_key[k] for k in
           ("brick", "stone", "marble", "bump_n", "rough")}
    return tm, ids


def sponza_stress(device=torch.device("cpu")):
    """bench.py's Sponza stress scene (bench.build_sponza_stress): the
    Sponza-substitute colonnade exported to a .glb (in a temporary
    directory of its own) and loaded back through scene/gltf.py, 220
    instanced clutter items (about 300k triangles with the LODs), the
    textured materials (five procedural 512^2 maps, the normal and
    roughness maps combined, diffuse and aux paired) and the 5 spot, 5
    point and 1 directional shadow casters with 6 more point lights. ->
    (SceneBuffers, lights, PackedTextures on `device`)."""
    from ..scene.gltf import load_gltf_meshes
    from ..scene.gltf_export import export_glb
    from ..scene.light import ELightType, Light
    from ..scene.scenes import _add_object, augment_sponza_substitute
    from ..scene.serialization import (FGameObjectRepresentation,
                                       FModelRepresentation,
                                       FSceneRepresentation)
    from ..utils import math3d as m3

    rng = np.random.default_rng(42)
    rep = FSceneRepresentation(name="SponzaStress")
    material_lib = {}
    augment_sponza_substitute(rep, material_lib)

    builtin = build_builtin_meshes()
    glb_objs = [(o.model.name or f"obj{i}",
                 builtin.get(o.model.builtin_mesh_name).lods[0],
                 o.transform.matrix(),
                 material_lib[o.model.material_name])
                for i, o in enumerate(rep.objects)]
    with tempfile.TemporaryDirectory() as tmp:
        glb_path = Path(tmp) / "vqe_bench_colonnade.glb"
        export_glb(glb_objs, glb_path)
        loaded = load_gltf_meshes(glb_path)
    if len(loaded) != len(glb_objs):
        raise RuntimeError(f"the colonnade's .glb loaded {len(loaded)} meshes "
                           f"of {len(glb_objs)}")
    gltf_obj = FGameObjectRepresentation()
    gltf_obj.transform = m3.Transform()
    gltf_obj.model = FModelRepresentation(path=str(glb_path),
                                          name="SponzaColonnadeGLB")
    rep.objects = [gltf_obj]

    tm, tex_ids = stress_textures()
    # brick walls, stone floors, bump + roughness; the glTF sub-materials
    # carry the PBR factors, the texture ids attach by material name
    gltf_mats = [m for _, m in loaded if m is not None]
    for m in list(material_lib.values()) + gltf_mats:
        diffuse = tex_ids["brick"] if "wall" in m.name.lower() else tex_ids["stone"]
        m.textures = {"diffuse": diffuse, "normal": tex_ids["bump_n"],
                      "roughness": tex_ids["rough"]}
    for i in range(10):
        m = Material(name=f"clutter{i}")
        m.diffuse = rng.uniform(0.2, 0.9, 3).astype(np.float32)
        m.roughness = float(rng.uniform(0.05, 0.95))
        m.metalness = float(i % 3 == 0)
        m.textures = {"diffuse": tex_ids["marble"],
                      "normal": tex_ids["bump_n"],
                      "roughness": tex_ids["rough"]}
        material_lib[m.name] = m
    all_mats = list(material_lib.values()) + gltf_mats
    tm.combine_aux_maps(all_mats)
    tm.combine_pair_quads(all_mats)
    textures = tm.build_device_arrays_packed(device)
    for i in range(220):
        mesh = "Sphere" if i % 2 == 0 else "Cube"
        pos = (rng.uniform(-900, 900), rng.uniform(20, 250),
               rng.uniform(-220, 220))
        s = rng.uniform(8, 30)
        _add_object(rep, mesh, pos, (s, s, s), f"clutter{rng.integers(0, 10)}",
                    rotation=m3.quat_from_euler_xyz_degrees(
                        *rng.uniform(0, 360, 3)),
                    name=f"Clutter{i}")

    lights = [Light(type=ELightType.DIRECTIONAL, brightness=1.4,
                    rotation=m3.quat_from_euler_xyz_degrees(35, 0, 25),
                    casts_shadows=True, viewport_x=2200, viewport_y=2200,
                    distance_from_origin=1500, shadow_near=1.0,
                    shadow_far=4000.0, depth_bias=0.002)]
    for i in range(5):          # shadowing spot lights along the ceiling
        lights.append(Light(
            type=ELightType.SPOT, brightness=26000.0, range=900.0,
            position=np.array([-700 + 350 * i, 420, 0], np.float32),
            rotation=m3.quat_from_euler_xyz_degrees(90, 0, 0),
            color=np.array([1.0, 0.95, 0.85], np.float32),
            inner_cone_deg=25.0, outer_cone_deg=38.0,
            casts_shadows=True, shadow_near=5.0, shadow_far=1200.0,
            depth_bias=0.004))
    for i in range(5):          # shadowing point lights between the columns
        lights.append(Light(
            type=ELightType.POINT, brightness=12000.0, range=500.0,
            position=np.array([-600 + 300 * i, 120,
                               -140 if i % 2 else 140], np.float32),
            color=rng.uniform(0.5, 1.0, 3).astype(np.float32),
            casts_shadows=True, shadow_near=2.0, shadow_far=600.0,
            depth_bias=0.15))
    for i in range(6):          # unshadowed point lights
        lights.append(Light(
            type=ELightType.POINT, brightness=8000.0, range=400.0,
            position=np.array([rng.uniform(-800, 800), 150,
                               rng.uniform(-150, 150)], np.float32),
            color=rng.uniform(0.4, 1.0, 3).astype(np.float32)))
    rep.lights = lights

    buffers, _, lights = assemble_scene(
        rep, builtin, material_lib, draw_light_gizmos=True,
        gltf_loader=lambda p: loaded)
    return buffers, lights, textures
