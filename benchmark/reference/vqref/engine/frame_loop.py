"""The engine's frame around the renderer: what the reference's
``engine.render_frame`` and ``tick`` (vqengine_tpu/engine/engine.py:427-478,
:835-836) do with a loaded scene from one frame to the next.

Per frame: the scene's update hook advances (StressTest's orbits and HDRI
yaw), the frame constants are rebuilt with the hook's yaw, the previous
frame's world matrices and view-projection; the moved items join the sticky
dynamic set (motion vectors take the palette path past 16 items); the
casters' shadow maps are rendered once and cached when nothing animates and
every caster is static or stationary, else the renderer draws them inside
every frame; the SSR history carries over. Frames render without readback
(no host read of the binning demand, so the pair bucket stays where it
is), as the engine's tick renders. engine/engine.VQEngineTorch is the
engine shell around the same steps (input, events, debug views, HUD and
render contexts).
"""
from __future__ import annotations

import math

import numpy as np

from ..render.graph import frame_constants_from_numpy
from ..render.renderer import VQRendererTorch, frame_constants_numpy
from ..scene.light import EMobility
from .scene_load import LoadedScene


class FrameLoop:
    """Frames of one loaded scene on a renderer that has uploaded it.
    flags: VQRendererTorch.render's flags (engine/settings.render_flags of
    the graphics settings, plus any the caller adds); the loop owns
    dynamic_item_ids, shadow_maps and ssr_history."""

    def __init__(self, renderer: VQRendererTorch, scene: LoadedScene,
                 width: int, height: int, flags: dict | None = None):
        self.renderer = renderer
        # the update hook reads and moves engine.scene_buffers.items
        self.scene_buffers = scene.buffers
        self.lights = scene.lights
        self.hook = scene.update_hook
        self.camera = scene.cameras[0]
        self.width, self.height = width, height
        self.flags = dict(flags or {})
        self.prev_world: np.ndarray | None = None
        self.prev_vp: np.ndarray | None = None
        self.dynamic_items: tuple = ()
        self.ssr_history = None
        self.static_maps: dict | None = None

    @property
    def cache_shadow_maps(self) -> bool:
        """STATIC/STATIONARY mobility: with no update hook and every enabled
        caster static or stationary, the maps are cached across frames
        (decided each frame, as the engine decides it)."""
        casters = [l for l in self.lights if l.enabled and l.casts_shadows]
        return self.hook is None and bool(casters) and all(
            l.mobility != EMobility.DYNAMIC for l in casters)

    def advance(self, dt: float = 1 / 60) -> None:
        """The simulation step: the scene's update hook, if it has one."""
        if self.hook is not None:
            self.hook(self, dt)

    def constants(self) -> dict:
        """This frame's constants as numpy leaves: the hook's HDRI yaw, the
        previous frame's world matrices and view-projection."""
        yaw01 = getattr(self.hook, "hdri_yaw", 0.0)
        return frame_constants_numpy(
            self.scene_buffers, self.camera, self.lights,
            hdri_yaw=yaw01 * 2.0 * math.pi, prev_world=self.prev_world,
            prev_view_proj=self.prev_vp)

    def render(self, readback: bool = False) -> dict:
        """One frame (readback: VQRendererTorch.render's; the engine's tick
        renders without)."""
        fields = self.constants()
        consts = frame_constants_from_numpy(fields, self.renderer.device)
        if self.cache_shadow_maps and self.static_maps is None:
            self.static_maps = self.renderer.precompute_shadow_maps(
                consts, shadow_dims=self.flags.get("shadow_dims"),
                filter_mode=self.flags.get("shadow_filter", "esm"))
        world = fields["world"]
        if self.prev_world is not None and self.prev_world.shape == world.shape:
            moved = np.flatnonzero(
                np.abs(world - self.prev_world).max(axis=(1, 2)) > 1e-6)
            if moved.size:
                self.dynamic_items = tuple(sorted(
                    set(self.dynamic_items) | {int(i) for i in moved}))
        self.prev_world = world
        self.prev_vp = fields["view_proj"]
        out = self.renderer.render(
            consts, self.width, self.height, readback=readback,
            shadow_maps=self.static_maps,
            ssr_history=self.ssr_history,
            dynamic_item_ids=self.dynamic_items, **self.flags)
        self.ssr_history = out.get("ssr_history")
        return out

    def tick(self) -> dict:
        """advance by 1/60, then render: the engine's tick."""
        self.advance()
        return self.render()
