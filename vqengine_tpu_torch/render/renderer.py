"""Renderer — counterpart of ``vqengine_tpu/render/renderer.py``
(VQRendererTPU): owns the device scene (its opaque and transparent
parts), its environment maps (built at load) and its textures, with the
scene's texture-slot usage and alpha-mask permutation, packs the per-frame
constants, renders the cached shadow maps of static casters, keeps the
demand-sized binning capacity (the pair bucket) and the frame statistics
(FRenderStats, for the profiler HUD and panel).

The reference caches one jitted graph per static option set; the port
runs eagerly, so there is no graph cache.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, fields

import numpy as np
import torch

from ..ops import colorspace as cs
from ..ops import raster
from ..scene.light import (ELightType, NUM_LIGHTS_POINT, NUM_LIGHTS_SPOT,
                           NUM_SHADOWING_LIGHTS_POINT,
                           NUM_SHADOWING_LIGHTS_SPOT, pack_directional,
                           pack_point_lights, pack_spot_extra,
                           pack_spot_lights)
from ..utils import math3d as m3
from ..utils import trace
from . import graph
from .scene_buffers import SceneBuffers, split_transparent


def _tensor_keep_bits(v, device: torch.device) -> torch.Tensor:
    """numpy -> tensor on `device`; ml_dtypes bfloat16 keeps its bits."""
    a = np.asarray(v)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    return graph._tensor(a, device)


def shadow_maps_from_numpy(maps: dict, device: torch.device) -> dict:
    """The JAX package's shadow-map dict (numpy leaves, from
    render_shadow_maps or precompute_shadow_maps) -> the port's, on
    `device`. bf16 maps arrive as ml_dtypes bfloat16 and keep their bits."""
    return {k: _tensor_keep_bits(v, device) for k, v in maps.items()}


def environment_from_numpy(maps: dict, device: torch.device) -> graph.EnvironmentMaps:
    """The JAX package's EnvironmentMaps as numpy leaves ({field: array},
    specular_mips a sequence of arrays) -> the port's, on `device`, bit
    for bit: the bf16 tables arrive as ml_dtypes bfloat16."""
    device = torch.device(device)
    fields = {k: _tensor_keep_bits(maps[k], device)
              for k in ("equirect", "diffuse_cube", "brdf_lut",
                        "sh_irradiance", "brdf_poly")}
    mips = tuple(_tensor_keep_bits(m, device) for m in maps["specular_mips"])
    return graph.EnvironmentMaps(device=device, specular_mips=mips, **fields)


def frame_constants_numpy(buffers: SceneBuffers, camera, lights,
                          ambient_factor: float = 0.055,
                          clear_color=(0.07, 0.07, 0.12),
                          hdri_yaw: float = 0.0,
                          prev_world: np.ndarray | None = None,
                          prev_view_proj: np.ndarray | None = None) -> dict:
    """The per-frame light and matrix data as numpy leaves of
    FrameConstants, packed as the reference's build_frame_constants
    packs them (Scene::GatherSceneLightData + the CB fills)."""
    world, nrm = buffers.world_matrices()
    enabled = [l for l in lights if l.enabled]

    def of(kind, casts):
        return [l for l in enabled if l.type == kind and l.casts_shadows == casts]

    points = of(ELightType.POINT, False)
    spots = of(ELightType.SPOT, False)
    point_casters = of(ELightType.POINT, True)[:NUM_SHADOWING_LIGHTS_POINT]
    spot_casters = of(ELightType.SPOT, True)[:NUM_SHADOWING_LIGHTS_SPOT]
    dirs = [l for l in enabled if l.type == ELightType.DIRECTIONAL]

    p_cap = max(1, min(len(points), NUM_LIGHTS_POINT))
    s_cap = max(1, min(len(spots), NUM_LIGHTS_SPOT))
    sc, pc = len(spot_casters), len(point_casters)
    # caster arrays keep their exact counts (zero-length = feature off)
    dir_caster = dirs[0] if (dirs and dirs[0].casts_shadows) else None
    vp = camera.view_projection()
    f32 = np.float32
    return dict(
        world=world, normal_mats=nrm,
        view_proj=vp, camera_pos=np.asarray(camera.position, f32),
        frustum_planes=m3.frustum_planes_from_viewproj(vp),
        inv_view_proj=np.linalg.inv(vp).astype(f32),
        hdri_yaw=np.asarray(hdri_yaw, f32),
        view_matrix=camera.view_matrix(),
        proj_params=np.asarray([camera.near_z, camera.far_z,
                                camera.fov_v_deg * np.pi / 180.0,
                                camera.aspect], f32),
        prev_world=prev_world if prev_world is not None else world,
        prev_view_proj=(prev_view_proj.astype(f32)
                        if prev_view_proj is not None else vp),
        point_lights=pack_point_lights(points, p_cap)[0],
        spot_lights=pack_spot_lights(spots, s_cap)[0],
        spot_extra=pack_spot_extra(spots, s_cap),
        directional=pack_directional(dirs[0] if dirs else None),
        ambient_factor=np.asarray(ambient_factor, f32),
        clear_color=np.asarray(clear_color, f32),
        spot_casters=(pack_spot_lights(spot_casters, sc)[0] if sc
                      else np.zeros((0, 12), f32)),
        spot_caster_extra=(pack_spot_extra(spot_casters, sc) if sc
                           else np.zeros((0, 4), f32)),
        spot_caster_vps=(np.stack([l.view_projection() for l in spot_casters])
                         if sc else np.zeros((0, 4, 4), f32)).astype(f32),
        point_casters=(pack_point_lights(point_casters, pc)[0] if pc
                       else np.zeros((0, 12), f32)),
        point_caster_vps=(np.stack([[l.view_projection(f) for f in range(6)]
                                    for l in point_casters])
                          if pc else np.zeros((0, 6, 4, 4), f32)).astype(f32),
        point_caster_range=(np.asarray([[l.shadow_near, l.shadow_far]
                                        for l in point_casters], f32)
                            if pc else np.zeros((0, 2), f32)),
        dir_vp=(dir_caster.view_projection()[None] if dir_caster is not None
                else np.zeros((0, 4, 4), f32)).astype(f32),
    )


@dataclass
class FRenderStats:
    """Reference Renderer.h:85-94. last_frame_ms: on a CUDA device the
    device time of the engine's last finished tick (its CUDA event pair,
    read once the device has passed it); on the CPU the host time of the
    last render."""
    num_frames_rendered: int = 0
    num_draws: int = 0
    last_frame_ms: float = 0.0


@dataclass
class FrameOutput:
    """A frame as the engine keeps it (the reference's FrameOutput): the
    render's tensors, on the renderer's device, by name; ldr may be a host
    array once the engine's debug views have drawn the UI panel into it."""
    ldr: object
    depth: torch.Tensor | None = None
    tri_id: torch.Tensor | None = None
    object_id: torch.Tensor | None = None
    ao: torch.Tensor | None = None
    motion: torch.Tensor | None = None
    ssr_history: torch.Tensor | None = None
    overflow: torch.Tensor | None = None
    hdr: torch.Tensor | None = None
    saturation: dict | None = None
    pair_demand: torch.Tensor | None = None

    @classmethod
    def of(cls, out: dict) -> "FrameOutput":
        """The FrameOutput of VQRendererTorch.render's dict."""
        return cls(**{f.name: out.get(f.name) for f in fields(cls)})


class VQRendererTorch:
    """Scene owner and frame entry point on one torch device."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.stats = FRenderStats()
        # the loaded scene's triangle count (FRenderStats.num_draws)
        self._num_tris = 0
        self.scene: graph.DeviceScene | None = None
        # the scene's transparent part (material alpha < 1), or None
        self.scene_t: graph.DeviceScene | None = None
        # demand-sized binning capacity (raster.pair_cap_bucket): None =
        # the safe T-sized default; grows with measured demand, resets to
        # the default on overflow
        self.pair_bucket: int | None = None
        self._pair_demand_max = 0
        # the scene's environment maps (graph.build_environment), or None
        self.env: graph.EnvironmentMaps | None = None
        # the scene's textures (ops.texture.PackedTextures), or None
        self.textures = None
        # the alpha-mask permutation (ENABLE_ALPHA_MASK): on when a material
        # carries a dedicated alpha-mask map (slot 3, material row 23)
        self._any_alpha_mask = False
        # the static texture-slot usage (graph.slots_used_of)
        self._slots_used: tuple | None = None

    def load_scene(self, buffers: SceneBuffers, equirect=None,
                   textures=None) -> None:
        """Upload the scene; with an equirect [He, We, 3] (the decoded
        environment, scene_load.LoadedScene.equirect) also build its
        environment maps on the device at the engine's default sizes, as
        its _build_environment_maps does at load; with textures (the
        scene's PackedTextures, scene_load.LoadedScene.textures) move them
        to the device."""
        self.textures = textures.to(self.device) if textures is not None else None
        self.env = (graph.build_environment(equirect, self.device)
                    if equirect is not None else None)
        opaque, transparent = split_transparent(buffers)
        self.scene = graph.upload_scene(opaque, self.device)
        self.scene_t = (graph.upload_scene(transparent, self.device)
                        if transparent is not None else None)
        self.pair_bucket = None
        self._pair_demand_max = 0
        self._any_alpha_mask = bool((buffers.materials[:, 23] >= 0).any())
        self._slots_used = graph.slots_used_of(buffers.materials)
        self._num_tris = int(buffers.indices.shape[0])

    def build_frame_constants(self, buffers: SceneBuffers, camera, lights,
                              **kw) -> graph.FrameConstants:
        return graph.frame_constants_from_numpy(
            frame_constants_numpy(buffers, camera, lights, **kw), self.device)

    def precompute_shadow_maps(self, consts: graph.FrameConstants,
                               shadow_dims: tuple[int, int, int] | None = None,
                               filter_mode: str = "esm") -> dict:
        """Render the casters' shadow maps once (STATIC/STATIONARY light
        mobility, Light.h:45-186); pass the result to render(...,
        shadow_maps=...) so that frames run only the shadow tests. The
        transparent part casts no shadow, as in the reference."""
        if self.scene is None:
            raise RuntimeError("load_scene first")
        return graph.render_shadow_maps(self.scene, consts,
                                        shadow_dims or graph.SHADOW_DIMS,
                                        filter_mode)

    def render(self, consts: graph.FrameConstants, width: int, height: int,
               hdr10: bool = False, readback: bool = True,
               render_scale: float = 1.0,
               cas_sharpness: float | None = None, **flags) -> dict:
        """One forward frame (graph.render_forward) at the current pair
        bucket, lit by the scene's environment maps (env=None renders
        without them) and textured by the scene's textures (textures=None
        renders without them), with the scene's transparent part blended
        over it. With readback (the default) the opaque pass's measured
        demand and overflow are read on the host and update the bucket;
        without, the frame makes no host read and leaves the bucket as it
        is, as the reference's engine tick renders (its bucket moves only
        on readback frames).
        hdr10 tonemaps to the ST.2084 curve instead of sRGB. render_scale
        (the engine's RenderScale) renders at max(64, int(width * scale)) x
        max(64, int(height * scale)) and FSR1 upscales ldr to width x
        height (not on the ST.2084 curve, as in the reference); the other
        outputs keep the render size. cas_sharpness (0..1, None = off)
        sharpens ldr with CAS.
        The textures are sampled with the scene's slot usage and, where a
        material has an alpha-mask map, the alpha-mask peel, as the
        reference's renderer keys them at load; aniso_taps > 1 walks the
        footprint of the anisotropic pixels. Flags pass through:
        aniso_taps, enable_shadows, shadow_dims, shadow_filter,
        shadow_maps, msaa, enable_ssao and ssao_quality,
        enable_motion_vectors and dynamic_item_ids (a set of more than 16
        items takes the palette path, as it would in motion_vectors),
        enable_ssr and ssr_history. The caller carries the history from
        out["ssr_history"] to the next frame, as the engine does; the
        renderer keeps none (engine/settings.render_flags maps the engine's
        graphics settings to these flags)."""
        if self.scene is None:
            raise RuntimeError("load_scene first")
        flags.setdefault("env", self.env)
        flags.setdefault("textures", self.textures)
        flags.setdefault("enable_alpha_mask", self._any_alpha_mask)
        flags.setdefault("slots_used", self._slots_used)
        ids = flags.get("dynamic_item_ids")
        if ids is not None and len(ids) > 16:
            flags["dynamic_item_ids"] = None
        if render_scale != 1.0:
            rw = max(64, int(width * render_scale))
            rh = max(64, int(height * render_scale))
        else:
            rw, rh = width, height
        curve = cs.DISPLAY_CURVE_ST2084 if hdr10 else cs.DISPLAY_CURVE_SRGB
        t0 = time.perf_counter()
        with trace.span("vq.render", self.device):
            out = graph.render_forward(self.scene, consts, rw, rh,
                                       output_display_curve=curve,
                                       out_width=width, out_height=height,
                                       cas_sharpness=cas_sharpness,
                                       pair_capacity=self.pair_bucket,
                                       scene_transparent=self.scene_t,
                                       **flags)
        if readback:
            self._update_pair_bucket(out)
        self.stats.num_frames_rendered += 1
        self.stats.num_draws = self._num_tris
        if self.device.type != "cuda":
            self.stats.last_frame_ms = (time.perf_counter() - t0) * 1e3
        return out

    def _update_pair_bucket(self, out: dict) -> None:
        """Sticky upward; an overflowing bucket resets to the safe default
        and regrows from fresh demand (reference: _update_pair_bucket)."""
        if (self.pair_bucket is not None
                and trace.read_int(out["overflow"].sum(),
                                   "renderer.overflow") > 0):
            self.pair_bucket = None
            self._pair_demand_max = 0
            return
        self._pair_demand_max = max(
            self._pair_demand_max,
            trace.read_int(out["pair_demand"], "renderer.pair_demand"))
        t = self.scene.num_tris_live
        bucket = raster.pair_cap_bucket(self._pair_demand_max, t)
        if bucket >= raster.default_pair_cap(t):
            return
        if self.pair_bucket is None or bucket > self.pair_bucket:
            self.pair_bucket = bucket
