"""The reference's frames of a cell: the level loaded, stepped and
rendered by the frozen copy of the port's plain paths (reference/vqref),
as the engine's tick does it with no input (camera 0, 1/60 s a tick).

It reads the same raw inputs as the program (the level's XML, the data
directory's settings and materials) and works out everything else again:
the scene's buffers, the animated items' transforms at each tick, the
frame constants, the environment maps and the static casters' shadow
maps. The one thing it takes from the program is the SSR history a judged
frame starts from (the program's previous frame's output), because it
cannot render the hundreds of frames before it; that history is itself
judged, frame by frame, and the run's first frame is judged from a fresh
start.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .vqref.engine.frame_loop import FrameLoop
from .vqref.engine.scene_load import (LoadedScene, decode_environment,
                                      find_data_dirs, load_environment_presets,
                                      load_material_lib,
                                      resolve_material_textures)
from .vqref.engine.settings import load_engine_settings, render_flags
from .vqref.render import graph
from .vqref.render.renderer import VQRendererTorch
from .vqref.render.scene_buffers import assemble_scene
from .vqref.scene.mesh import build_builtin_meshes
from .vqref.scene.scenes import augment_scene
from .vqref.scene.serialization import parse_scene_file
from .vqref.scene.texture_manager import TextureManager


DT = 1 / 60          # VQEngineTorch.tick's default step


class Level:
    """One level at width x height on `device`, from the data directory."""

    def __init__(self, level: str, width: int, height: int,
                 device: torch.device, env_sizes: dict | None = None):
        self.device = torch.device(device)
        self.width, self.height = width, height
        data_dirs = find_data_dirs()
        _, gfx = load_engine_settings(data_dirs[0])
        self.gfx = gfx
        tm = TextureManager()
        lib, tex_paths = load_material_lib(data_dirs, tm)
        path = next(d / "Levels" / f"{level}.xml" for d in data_dirs
                    if (d / "Levels" / f"{level}.xml").is_file())
        rep = parse_scene_file(path)
        meshes = build_builtin_meshes()
        hook = augment_scene(rep.name, rep, lib, meshes, data_dirs=data_dirs)
        used = {o.model.material_name for o in rep.objects
                if o.model.material_name}
        resolve_material_textures(tm, lib, tex_paths, used, data_dirs)
        buffers, cameras, lights = assemble_scene(
            rep, meshes, lib, gltf_loader=_gltf_loader(data_dirs),
            draw_light_gizmos=gfx.bDrawLightBounds,
            draw_bounding_boxes=gfx.bDrawBoundingBoxes)
        for c in cameras:
            c.aspect = width / max(1, height)
        equirect, _ = decode_environment(rep, data_dirs,
                                         load_environment_presets(data_dirs))
        self.renderer = VQRendererTorch(self.device)
        self.renderer.load_scene(buffers)
        self.env = (graph.build_environment(
            equirect, self.device, **(env_sizes or dict(
                diffuse_size=64, specular_base=128)))
            if equirect is not None else None)
        self.loop = FrameLoop(self.renderer, LoadedScene(
            name=rep.name, buffers=buffers, cameras=cameras, lights=lights,
            wants_environment=equirect is not None, textures=None,
            has_shadow_casters=any(l.enabled and l.casts_shadows
                                   for l in lights),
            update_hook=hook), width, height)
        self.loop.flags = dict(render_flags(gfx), env=self.env, textures=None)
        self.triangles = int(buffers.indices.shape[0])
        self.tick = -1              # the last tick stepped

    def advance_to(self, tick: int) -> None:
        """Step the update hook up to `tick`, keeping the frame loop's
        previous-frame state as the engine's frames up to it left it."""
        loop = self.loop
        while self.tick < tick - 1:
            self.tick += 1
            loop.advance(DT)
            world, _ = loop.scene_buffers.world_matrices()
            vp = loop.camera.view_projection()
            if loop.prev_world is not None and loop.prev_world.shape == world.shape:
                moved = np.flatnonzero(
                    np.abs(world - loop.prev_world).max(axis=(1, 2)) > 1e-6)
                loop.dynamic_items = tuple(sorted(
                    set(loop.dynamic_items) | {int(i) for i in moved}))
            loop.prev_world, loop.prev_vp = world, vp
        self.tick = tick
        loop.advance(DT)

    def render(self, tick: int, ssr_history) -> dict:
        """Frame `tick` from the given SSR history (None: a fresh start) ->
        {"ldr", "ssr_history"} on the device."""
        if tick <= self.tick:
            raise ValueError(f"tick {tick} after tick {self.tick}")
        self.advance_to(tick)
        loop = self.loop
        loop.ssr_history = ssr_history
        out = loop.render(readback=False)
        return {"ldr": out["ldr"], "ssr_history": out.get("ssr_history")}


def _gltf_loader(data_dirs):
    from .vqref.scene.gltf import load_gltf_meshes

    def load(path: str):
        for base in [d.parent for d in data_dirs] + [Path(".")]:
            p = Path(base) / path
            if p.is_file():
                try:
                    return load_gltf_meshes(p)
                except Exception:  # noqa: BLE001 — the engine's fallback
                    return None
        return None
    return load
