"""Host-only scene load: data directories, the material library, level
XML parse, typed-scene augmentation and assembly into SceneBuffers, and
the decode of the scene's environment map.

Counterpart of the host half of ``vqengine_tpu/engine/engine.py``
(find_data_dirs, _load_material_lib, _load_scene_host,
_decode_environment), on the port's own copies of the JAX package's
numpy host modules (scene, utils, render.scene_buffers,
engine.settings), so it imports neither jax nor the JAX package.
Textures are not decoded: the result only says whether the scene wants
them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from ..ops.ibl import procedural_sky_equirect
from ..render.scene_buffers import SceneBuffers, assemble_scene
from ..scene.material import Material
from ..scene.mesh import build_builtin_meshes
from ..scene.scenes import augment_scene
from ..scene.serialization import parse_material_file, parse_scene_file
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


def load_material_lib(data_dirs: list[Path]) -> tuple[dict, dict]:
    """-> (name -> Material, name -> {slot: texture path}); earlier data
    dirs win."""
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
    for tid, name in enumerate(("Checkerboard", "Checkerboard_Grayscale")):
        m = Material(name=name)
        m.textures["diffuse"] = tid
        lib[name] = m
    return lib, tex_paths


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
    wants_textures: bool
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
    lib, tex_paths = load_material_lib(data_dirs)
    rep = parse_scene_file(path)
    meshes = build_builtin_meshes()
    augment_scene(rep.name, rep, lib, meshes, data_dirs=data_dirs)
    for mname, alpha in (material_alpha or {}).items():
        lib[mname].alpha = float(alpha)
    used = {o.model.material_name for o in rep.objects if o.model.material_name}
    buffers, cameras, lights = assemble_scene(
        rep, meshes, lib, draw_light_gizmos=draw_light_gizmos)
    for c in cameras:
        c.aspect = width / max(1, height)
    wants_textures = any(tex_paths.get(n) or (n in lib and lib[n].textures)
                         for n in used)
    has_casters = any(l.enabled and l.casts_shadows for l in lights)
    equirect, max_cll = decode_environment(
        rep, data_dirs, load_environment_presets(data_dirs))
    log.info(f"scene '{rep.name}': {buffers.indices.shape[0]} tris, "
             f"{len(buffers.items)} items")
    return LoadedScene(name=rep.name, buffers=buffers, cameras=cameras,
                       lights=lights,
                       wants_environment=bool(rep.env_map_preset
                                              or rep.env_map_path),
                       wants_textures=bool(wants_textures),
                       has_shadow_casters=has_casters,
                       equirect=equirect, env_max_cll=max_cll)
