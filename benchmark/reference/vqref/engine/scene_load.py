"""Host-side scene load: data directories, the material library, level
XML parse, typed-scene augmentation and assembly into SceneBuffers, the
scene's textures, and the decode of the scene's environment map.

Counterpart of the host half of ``vqengine_tpu/engine/engine.py``
(find_data_dirs, _load_material_lib, _resolve_material_textures,
_load_scene_host, _decode_environment), on the port's own copies of the
JAX package's numpy host modules (scene, utils, render.scene_buffers,
engine.settings), so it imports neither jax nor the JAX package. The textures are packed into
host (CPU) tensors; VQRendererTorch.load_scene moves them to its device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from ..ops.ibl import procedural_sky_equirect
from ..render.scene_buffers import SceneBuffers
from ..scene.material import Material
from ..scene.serialization import parse_material_file
from ..scene.texture_manager import (ETextureState, TextureManager,
                                     checkerboard, checkerboard_grayscale)
from ..utils import log
from ..utils.image_io import read_hdr
from .settings import load_environment_map_presets

# the checkout's Data/ (this copy lives in benchmark/reference/vqref/engine)
REPO_DATA = Path(__file__).resolve().parents[4] / "Data"


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
    # the scene's per-frame animation (StressTest's StressTestAnimation),
    # called as hook(engine, dt) with engine.scene_buffers the buffers;
    # engine/frame_loop.FrameLoop drives it
    update_hook: object | None = None
