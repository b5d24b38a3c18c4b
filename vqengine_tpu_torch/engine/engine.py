"""VQEngineTorch — the app shell, counterpart of ``vqengine_tpu/engine/
engine.py`` (VQEngineTPU; reference VQEngine.h:95-415): the app state
machine INITIALIZING -> LOADING -> SIMULATING -> UNLOADING -> EXITING
(VQEngine.h:72-81), scene loading (VQEngine_Update.cpp:483-560), synchronous
or on a worker pool, the -Test/-TestFrames automated run contract
(Main.cpp:65-86, VQEngine_Main.cpp:60-77) and the frame loop
(VQEngine_Simulation.cpp:88-105).

Headless: frames dump to PNG instead of a swapchain present. One host
thread drives the card; torch's asynchronous launches replace the update
and render thread pipelining. The frame itself is engine/frame_loop's
FrameLoop (constants, the sticky dynamic set, the static casters' map
cache, the SSR history), rendered without readback as the reference's tick
renders; the host loads are engine/scene_load's. Runs on the card unless
the caller passes a CPU device.
"""
from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import enum
import time
from pathlib import Path

import numpy as np
import torch

from ..ops import colorspace as cs
from ..ops import postprocess as pp
from ..ops import visualization as viz
from ..render import graph
from ..render.renderer import FrameOutput, VQRendererTorch
from ..render.scene_buffers import assemble_scene
from ..scene.camera import Camera
from ..scene.mesh import build_builtin_meshes
from ..scene.scenes import augment_scene
from ..scene.serialization import FSceneRepresentation, parse_scene_file
from ..scene.texture_manager import TextureManager
from ..utils import log, trace
from ..utils.image_io import write_png
from . import events as ev
from .cli import parse_command_line
from .frame_loop import FrameLoop
from .input import Input
from .scene_load import (LoadedScene, any_textured, decode_environment,
                         find_data_dirs, load_environment_presets,
                         load_material_lib, resolve_material_textures)
from .settings import (FStartupParameters, hdr_reference_brightness,
                       load_engine_settings, load_hdr_display_profiles,
                       load_scene_mapping, render_flags)


class EAppState(enum.Enum):
    """Reference VQEngine.h:72-81."""
    INITIALIZING = 0
    LOADING = 1
    SIMULATING = 2
    UNLOADING = 3
    EXITING = 4


def engine_device(device=None) -> torch.device:
    """The engine's device: the card unless the caller asks for another
    (the tests pass the CPU). With no card and none asked for, fail: the
    engine never carries on on the CPU by itself."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the engine runs on the card "
                           "(pass device=torch.device('cpu') to run on the "
                           "CPU)")
    return torch.device("cuda")


class TickClock:
    """The device time of finished ticks, read without blocking: on a CUDA
    device one event pair per tick, read on a later tick once query() says
    the device has passed its end; elsewhere nothing (None)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self._pending: collections.deque = collections.deque()

    def start(self):
        """The tick's start event (None off CUDA)."""
        if not self.cuda:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def stop(self, start) -> float | None:
        """Record the tick's end; -> the ms of the newest tick the device
        has finished since the last call, or None."""
        if start is None:
            return None
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        self._pending.append((start, end))
        ms = None
        while self._pending and self._pending[0][1].query():
            a, b = self._pending.popleft()
            ms = a.elapsed_time(b)
        return ms


def _host(x) -> np.ndarray:
    """A frame's tensor (or an array the UI panel drew into) on the host."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class VQEngineTorch:
    def __init__(self, argv: list[str] | None = None,
                 startup: FStartupParameters | None = None, device=None):
        self.device = engine_device(device)
        self.state = EAppState.INITIALIZING
        startup = startup or parse_command_line(argv or [])
        self.data_dirs = find_data_dirs()
        self.data_dir = self.data_dirs[0] if self.data_dirs else None
        self.settings, self.gfx = load_engine_settings(self.data_dir, startup)
        log.initialize(console=self.settings.bLogConsole,
                       file=self.settings.bLogFile,
                       file_path=self.settings.LogFilePath)
        log.info(f"VQEngineTorch initializing on {self.device} "
                 f"(data dirs: {self.data_dirs})")

        self.scene_mapping = {}
        self.hdr_profiles = {}
        for d in reversed(self.data_dirs):  # earlier dirs win
            self.scene_mapping.update(load_scene_mapping(d))
            self.hdr_profiles.update(load_hdr_display_profiles(d))
        self.env_presets = load_environment_presets(self.data_dirs)
        # environment MaxCLL (nits) of the active env preset; with the
        # display profile it sets the HDR10 encode brightness the way the
        # reference's SetHDRMetaData does (SwapChain.h:76-99)
        self._env_max_cll = 0.0
        self.builtin_meshes = build_builtin_meshes()
        self.texture_manager = TextureManager()
        self.texture_arrays = None
        self.material_lib, self.material_tex_paths = load_material_lib(
            self.data_dirs, self.texture_manager)
        log.info(f"loaded {len(self.material_lib)} materials")
        self.renderer = VQRendererTorch(self.device)

        self.scene_buffers = None
        self.cameras = []
        self.lights = []
        self.active_camera = 0
        self.scene_name = ""
        self.num_ticks = 0
        self.scene_update_hook = None  # fn(engine, dt) for animated scenes
        self.environment = None        # EnvironmentMaps after scene load
        # the frame's state across ticks, from the scene's load on
        # (FrameLoop): the motion-vector history, the sticky moved-item
        # set, the static casters' maps and the SSR history
        self.loop: FrameLoop | None = None
        self._last_output: FrameOutput | None = None  # picking readback source
        # UI/debug state (the VQUI F3 draw-mode dropdown, MagnifierPass
        # params and the editor's selected-object outline)
        self.draw_mode = 0             # visualization.DRAW_MODE_*
        self.magnifier_on = False
        self.magnifier_center = (0.5, 0.5)
        self.selected_object = -1
        # VQUI windows (VQUI.h:36-66): 0 closed, 1..4 = F1..F4 panel
        self.ui_panel = 0
        self._ui_cursor = 0
        self._shadow_filter_cached = None  # filter the cached maps used
        self._render_contexts: dict = {}

        self.input = Input()
        self.events = ev.BufferedEventQueue()
        self._last_stats_log = time.perf_counter()
        # host seconds of the last 256 ticks (the periodic log's window)
        self._frame_times: collections.deque = collections.deque(maxlen=256)
        self._tick_clock = TickClock(self.device)
        # async loading (the reference's mWorkers_ModelLoading / background
        # env-map queues): host-side parse/decode runs on this pool while
        # frames keep flowing; the device upload and the IBL prefilter
        # finalize on the main thread when the future completes
        self._async_pool = concurrent.futures.ThreadPoolExecutor(max_workers=2)
        self._env_future = None
        self._scene_future = None

    # ------------------------------------------------------------------
    def resolve_scene_file(self, name_or_index) -> Path | None:
        if isinstance(name_or_index, int):
            inv = {v: k for k, v in self.scene_mapping.items()}
            name = inv.get(name_or_index)
            if name is None:
                return None
        else:
            name = name_or_index
        for d in self.data_dirs:
            p = d / "Levels" / f"{name}.xml"
            if p.is_file():
                return p
        return None

    def start_loading_scene(self, name_or_index) -> bool:
        """Reference VQEngine::StartLoadingScene (VQEngine_Main.cpp:680) +
        Load_SceneData_Dispatch (VQEngine_Update.cpp:483). Synchronous:
        host parse/assemble + device upload in one call."""
        self.state = EAppState.LOADING
        host = self._load_scene_host(name_or_index)
        if host is None:
            return False
        self._finalize_scene_load(host)
        return True

    def start_loading_scene_async(self, name_or_index) -> bool:
        """Dispatch the host-side load (XML parse, procedural generation,
        glTF import, texture decode, HDRI read) to the worker pool; frames
        keep flowing until poll_scene_loading() finalizes the device upload
        (the reference's mWorkers_ModelLoading pipeline + OnLoadComplete,
        SceneLoading.cpp:100/451)."""
        self.state = EAppState.LOADING
        self._scene_future = self._async_pool.submit(
            self._load_scene_host, name_or_index)
        return True

    def poll_scene_loading(self) -> bool:
        """Finalize a pending async scene load if its host work is done.
        Returns True when a new scene just became active."""
        if self._scene_future is None or not self._scene_future.done():
            return False
        host = self._scene_future.result()
        self._scene_future = None
        if host is None:
            log.error("async scene load failed")
            return False
        self._finalize_scene_load(host)
        return True

    def _load_scene_host(self, name_or_index):
        """Host-side (numpy/IO only) part of a scene load."""
        path = self.resolve_scene_file(name_or_index)
        if path is None:
            log.error(f"scene '{name_or_index}' not found")
            return None
        t0 = time.perf_counter()
        rep = parse_scene_file(path)
        # typed-scene augmentation (the Scene subclass behaviors,
        # Source/Scenes/*.cpp): procedural objects + update hooks
        hook = augment_scene(rep.name, rep, self.material_lib,
                             self.builtin_meshes, data_dirs=self.data_dirs)
        used = {o.model.material_name for o in rep.objects
                if o.model.material_name}
        resolve_material_textures(self.texture_manager, self.material_lib,
                                  self.material_tex_paths, used,
                                  self.data_dirs)
        buffers, cameras, lights = assemble_scene(
            rep, self.builtin_meshes, self.material_lib,
            gltf_loader=self._gltf_loader,
            draw_light_gizmos=self.gfx.bDrawLightBounds,
            draw_bounding_boxes=self.gfx.bDrawBoundingBoxes)
        textured = any_textured(self.material_lib, used, buffers)
        equirect = self._decode_environment(rep)
        return dict(rep=rep, hook=hook, buffers=buffers, cameras=cameras,
                    lights=lights, any_textured=textured,
                    equirect=equirect, t0=t0)

    def _finalize_scene_load(self, host) -> None:
        """Device-side completion (main thread): uploads + IBL prefilter
        (the reference's OnLoadComplete heap uploads)."""
        rep, buffers = host["rep"], host["buffers"]
        self.scene_name = rep.name
        self.scene_update_hook = host["hook"]
        self.scene_buffers = buffers
        self.cameras = host["cameras"]
        self.lights = host["lights"]
        self.active_camera = 0
        aspect = self.settings.Width / max(1, self.settings.Height)
        for c in self.cameras:
            c.aspect = aspect
        self.renderer.load_scene(buffers)
        self.loop = FrameLoop(self.renderer, LoadedScene(
            name=rep.name, buffers=buffers, cameras=self.cameras,
            lights=self.lights,
            wants_environment=host["equirect"] is not None, textures=None,
            has_shadow_casters=any(l.enabled and l.casts_shadows
                                   for l in self.lights),
            update_hook=self.scene_update_hook),
            self.settings.Width, self.settings.Height)
        self._last_output = None
        # quad-packed RGBA8 is the production sampling layout (one row
        # gather per bilinear tap); see ops/texture.py PackedTextures
        self.texture_arrays = (
            self.texture_manager.build_device_arrays_packed(self.device)
            if host["any_textured"] else None)
        self.environment = self._build_environment_maps(host["equirect"])
        log.info(f"scene '{rep.name}' loaded in "
                 f"{time.perf_counter()-host['t0']:.2f}s "
                 f"({len(buffers.items)} items, {len(self.lights)} lights, "
                 f"env={'yes' if self.environment is not None else 'no'})")
        self.state = EAppState.SIMULATING

    def hdr_display_brightness(self, default: float = 200.0) -> float:
        """ST2084 reference brightness (nits) = display profile
        MaxBrightness clamped by the environment's MaxCLL (see
        settings.hdr_reference_brightness)."""
        return hdr_reference_brightness(
            self.hdr_profiles, self.settings.HDRProfile,
            self._env_max_cll, default)

    def _decode_environment(self, rep):
        """Host-side env-map decode (scene_load.decode_environment): preset
        -> HDRI file -> equirect array, a procedural sky when the file is
        missing; None = the scene wants no environment. Sets the preset's
        MaxCLL."""
        equirect, max_cll = decode_environment(rep, self.data_dirs,
                                               self.env_presets)
        if equirect is not None:
            self._env_max_cll = max_cll
        return equirect

    def _build_environment_maps(self, equirect, diffuse_size: int = 64,
                                specular_base: int = 128, **sizes):
        """Device-side IBL prefiltering (the reference's background-queue
        PreFilterEnvironmentMap, EnvironmentMapRendering.cpp:139-486), at
        the engine's sizes unless given others (graph.build_environment's)."""
        if equirect is None:
            return None
        t0 = time.perf_counter()
        env = graph.build_environment(equirect, self.device,
                                      diffuse_size=diffuse_size,
                                      specular_base=specular_base, **sizes)
        log.info(f"IBL prefilter done in {time.perf_counter()-t0:.2f}s")
        return env

    def _gltf_loader(self, path: str):
        from ..scene.gltf import load_gltf_meshes
        bases = [d.parent for d in self.data_dirs] + [Path(".")]
        for base in bases:
            p = Path(base) / path
            if p.is_file():
                try:
                    return load_gltf_meshes(p)
                except Exception as e:  # noqa: BLE001
                    log.warning(f"glTF load failed for {p}: {e}")
        return None

    # ------------------------------------------------------------------
    def render_frame(self, readback: bool = True) -> FrameOutput:
        """One frame of the active camera with the live graphics settings
        (FrameLoop.render: the hook's HDRI yaw, the previous frame's
        matrices, the sticky dynamic set, the static casters' maps cached
        and re-rendered when the shadow filter changes, the SSR history),
        then the debug views."""
        loop = self.loop
        loop.camera = self.cameras[self.active_camera]
        loop.width, loop.height = self.settings.Width, self.settings.Height
        if self._shadow_filter_cached not in (None, self.gfx.ShadowFilter):
            loop.static_maps = None   # filter changed (F3 toggle)
        loop.flags = dict(render_flags(self.gfx), env=self.environment,
                          textures=self.texture_arrays)
        cached = loop.static_maps is not None
        out = loop.render(readback=readback)
        if not cached and loop.static_maps is not None:
            self._shadow_filter_cached = self.gfx.ShadowFilter
            n = sum(1 for l in self.lights if l.enabled and l.casts_shadows)
            log.info(f"static shadow maps cached ({n} casters)")
        self._last_output = FrameOutput.of(out)
        with trace.span("vq.tick.debug_views"):
            self._apply_debug_views()
        return self._last_output

    # ------------------------------------------------------------------
    # secondary render contexts (WindowRenderContext.h:44-75: per-window
    # swapchain + present queue + display resolution; Renderer.cpp:735
    # InitializeRenderContext). Headless counterpart: named outputs with
    # their own resolution, camera, and display curve, rendered after the
    # main view each tick; `run` dumps them alongside the main frames.
    # ------------------------------------------------------------------

    def create_render_context(self, name: str, width: int, height: int,
                              camera_index: int = 0,
                              hdr10: bool = False) -> None:
        self._render_contexts[name] = {
            "width": int(width), "height": int(height),
            "camera": int(camera_index), "hdr10": bool(hdr10),
            "last": None}

    def destroy_render_context(self, name: str) -> None:
        self._render_contexts.pop(name, None)

    def context_output(self, name: str):
        ctx = self._render_contexts.get(name)
        return None if ctx is None else ctx["last"]

    def _render_extra_contexts(self) -> None:
        """Each context's frame, with readback as the reference renders
        them (its demand moves the shared pair bucket)."""
        if not self._render_contexts or self.scene_buffers is None:
            return
        for name, ctx in self._render_contexts.items():
            cam_i = min(ctx["camera"], len(self.cameras) - 1)
            src = self.cameras[cam_i]
            # per-context aspect: same pose/lens, this window's projection
            cam = Camera(src.params, aspect=ctx["width"] / ctx["height"])
            cam.position = src.position.copy()
            cam.pitch, cam.yaw = src.pitch, src.yaw
            consts = self.renderer.build_frame_constants(
                self.scene_buffers, cam, self.lights)
            ctx["last"] = FrameOutput.of(self.renderer.render(
                consts, ctx["width"], ctx["height"], hdr10=ctx["hdr10"],
                env=self.environment, textures=self.texture_arrays,
                enable_ssao=False, msaa=False, enable_ssr=False,
                shadow_maps=self.loop.static_maps))

    def _build_ui_panel(self):
        """Construct the open VQUI window against live engine state,
        restoring the persistent cursor (panels rebuild per frame like
        immediate-mode UI; the cursor is the only retained state)."""
        from ..render import ui
        builders = {1: ui.build_controls_panel,
                    2: lambda: ui.build_profiler_panel(self),
                    3: lambda: ui.build_settings_panel(self),
                    4: lambda: ui.build_editor_panel(self)}
        b = builders.get(self.ui_panel)
        if b is None:
            return None
        panel = b()
        panel.cursor = self._ui_cursor
        if panel.cursor not in panel.interactive_rows():
            rows = panel.interactive_rows()
            panel.cursor = rows[0] if rows else 0
        return panel

    def _apply_debug_views(self) -> None:
        """Engine-side debug view chain on the finished frame, on the
        renderer's device: draw-mode visualization (Visualization.hlsl CS),
        selected-object outline (OutlinePass), the magnifier lens
        (MagnifierPass); then the VQUI panel composite (UIPass), drawn on
        the host."""
        out = self._last_output
        if out is None or out.ldr is None:
            return
        if not (self.draw_mode or self.magnifier_on or self.ui_panel
                or self.selected_object >= 0):
            return
        ldr = out.ldr
        if self.draw_mode:
            ldr = viz.visualize(self.draw_mode, ldr, depth=out.depth,
                                ao=out.ao, motion=out.motion,
                                object_id=out.object_id)
        if self.selected_object >= 0 and out.object_id is not None:
            ldr = viz.outline(ldr, out.object_id, self.selected_object)
        if self.magnifier_on:
            ldr = viz.magnifier(ldr, self.magnifier_center)
        if self.ui_panel:
            from ..render import ui
            panel = self._build_ui_panel()
            if panel is not None:
                ldr = ui.draw_panel(_host(ldr), panel)
        self._last_output = dataclasses.replace(out, ldr=ldr)

    def pick(self, x: int, y: int) -> int:
        """Mouse-picking readback (the reference's ObjectID pass + async
        COPY-queue readback, ObjectIDPass.cpp:398-428 /
        VQEngine_Update.cpp:242-278): returns the object id under the
        pixel, or -1."""
        if self._last_output is None or self._last_output.object_id is None:
            return -1
        oid = self._last_output.object_id
        if 0 <= y < oid.shape[0] and 0 <= x < oid.shape[1]:
            return int(oid[y, x])
        return -1

    # ------------------------------------------------------------------
    # events + input (VQEngine_EventHandlers.cpp / HandleEngineInput,
    # VQEngine_Update.cpp:459-469)
    # ------------------------------------------------------------------
    def handle_events(self) -> None:
        for e in self.events.swap_and_drain():
            if isinstance(e, ev.WindowResizeEvent):
                self.settings.Width = e.width
                self.settings.Height = e.height
                aspect = e.width / max(1, e.height)
                for c in self.cameras:
                    c.aspect = aspect
                log.info(f"resized to {e.width}x{e.height}")
            elif isinstance(e, ev.SetVSyncEvent):
                self.gfx.bVsync = e.enabled
            elif isinstance(e, ev.SetHDREvent):
                self.gfx.bHDR = e.enabled
            elif isinstance(e, ev.SetEnvironmentMapEvent):
                # async: the HDRI decode runs on the worker pool and the
                # prefilter finalizes in a later tick; frames keep flowing
                # through an env switch (the reference's background env
                # queues, Renderer.h:342-355)
                rep = FSceneRepresentation(env_map_preset=e.preset)
                self._env_future = self._async_pool.submit(
                    self._decode_environment, rep)
            elif isinstance(e, ev.KeyDownEvent):
                self.input.on_key_down(e.key)
            elif isinstance(e, ev.KeyUpEvent):
                self.input.on_key_up(e.key)
            elif isinstance(e, ev.MouseMoveEvent):
                self.input.on_mouse_move(e.dx, e.dy)
            elif isinstance(e, ev.MouseClickEvent):
                self.input.on_mouse_click(e.x, e.y, e.button)

    def handle_engine_input(self, dt: float) -> None:
        """The reference's engine-level key bindings
        (HandleEngineInput + UI toggles)."""
        inp = self.input
        # camera switch by number keys (Scene::Update)
        for i in range(min(9, len(self.cameras))):
            if inp.is_key_triggered(str(i + 1)):
                self.active_camera = i
        # environment-map cycling (PageUp/PageDown, VQEngine_Main.cpp:669)
        presets = list(self.env_presets)
        if presets and (inp.is_key_triggered("pageup")
                        or inp.is_key_triggered("pagedown")):
            cur = getattr(self, "_env_index", 0)
            step = 1 if inp.is_key_triggered("pageup") else -1
            self._env_index = (cur + step) % len(presets)
            self.events.push(ev.SetEnvironmentMapEvent(presets[self._env_index]))
        # first-person camera drive
        cam = self.cameras[self.active_camera] if self.cameras else None
        if cam is not None:
            move = inp.wasd_vector()
            if move.any() or inp.mouse_dx or inp.mouse_dy:
                cam.update_first_person(
                    dt, move * 0.01,
                    d_yaw_deg=inp.mouse_dx * cam.params.angular_speed * 57.3 * 0.01,
                    d_pitch_deg=inp.mouse_dy * cam.params.angular_speed * 57.3 * 0.01)
        # mouse picking on click (VQEngine_Update.cpp:242-278); the picked
        # object drives the editor outline (OutlinePass)
        for (x, y, _b) in inp.clicks():
            picked = self.pick(x, y)
            self.selected_object = picked
            log.info(f"picked object {picked} at ({x},{y})")
        # draw-mode cycle + magnifier toggle (VQUI F3 dropdown /
        # MagnifierPass; bound to plain keys in the windowless build)
        if inp.is_key_triggered("v"):
            self.draw_mode = (self.draw_mode + 1) % 9
            log.info(f"draw mode {self.draw_mode}")
        if inp.is_key_triggered("m"):
            self.magnifier_on = not self.magnifier_on
        # VQUI windows (VQUI.h:36-66): F1 controls, F2 profiler,
        # F3 graphics settings, F4 editor; arrows navigate, left/right/
        # enter change the focused row; edits write through to live
        # engine state (the ImGui widget -> engine write path)
        for i in range(1, 5):
            if inp.is_key_triggered(f"f{i}"):
                self.ui_panel = 0 if self.ui_panel == i else i
                self._ui_cursor = 0
        if self.ui_panel:
            panel = self._build_ui_panel()
            if panel is not None:
                if inp.is_key_triggered("up"):
                    panel.move_cursor(-1)
                if inp.is_key_triggered("down"):
                    panel.move_cursor(1)
                direction = 0
                if inp.is_key_triggered("left"):
                    direction = -1
                if inp.is_key_triggered("right") or inp.is_key_triggered("enter"):
                    direction = 1
                if direction:
                    before = (self.gfx.RenderScale, self.gfx.Reflections,
                              self.gfx.bMotionVectors)
                    panel.adjust(direction)
                    if before != (self.gfx.RenderScale,
                                  self.gfx.Reflections,
                                  self.gfx.bMotionVectors):
                        self.loop.ssr_history = None  # shape/config changed
                self._ui_cursor = panel.cursor

    # ------------------------------------------------------------------
    # editor mutation API (the VQUI F4 editor's material/light/object
    # panels, VQUI.h:36-66; headless surface: call these, the next frame
    # renders the change)
    # ------------------------------------------------------------------

    _MATERIAL_COLS = {
        "diffuse": (0, 3), "alpha": (3, 1), "emissive_color": (4, 3),
        "emissive_intensity": (7, 1), "uv_scale": (8, 2),
        "uv_offset": (10, 2), "roughness": (12, 1), "metalness": (13, 1),
        "displacement": (14, 1), "normal_map_mip_bias": (16, 1),
    }

    def editor_material_of_object(self, object_id: int) -> str | None:
        """Material name of the item with the given object id (the F4
        editor's selection -> material panel binding)."""
        bufs = self.scene_buffers
        if bufs is None or object_id < 0:
            return None
        hits = np.nonzero(np.asarray(bufs.item_object) == object_id)[0]
        if hits.size == 0:
            return None
        mid = int(bufs.item_material[hits[0]])
        if 0 <= mid < len(bufs.material_names):
            return bufs.material_names[mid]
        return None

    def editor_get_material(self, name: str, key: str):
        """Read a packed material parameter by name (the editor panel's
        display path; inverse of editor_set_material)."""
        bufs = self.scene_buffers
        if bufs is None or name not in bufs.material_names:
            return None
        span = self._MATERIAL_COLS.get(key)
        if span is None:
            return None
        row = bufs.material_names.index(name)
        off, width = span
        vals = np.asarray(bufs.materials)[row, off:off + width]
        return vals if width > 1 else float(vals[0])

    def editor_set_material(self, name: str, **params) -> bool:
        """Mutate packed material parameters by name and hot-swap the
        device materials (the renderer's opaque and transparent parts: a
        [M, 32] upload, the editor's live-tweak path). Returns False for an
        unknown material or parameter."""
        bufs = self.scene_buffers
        if bufs is None or name not in bufs.material_names:
            return False
        row = bufs.material_names.index(name)
        for key, val in params.items():
            span = self._MATERIAL_COLS.get(key)
            if span is None:
                return False
            off, width = span
            bufs.materials[row, off:off + width] = np.asarray(
                val, np.float32).reshape(width)
        mat = self.material_lib.get(name)
        if mat is not None:
            for key, val in params.items():
                if hasattr(mat, key):
                    setattr(mat, key, val)
        new_m = torch.from_numpy(np.ascontiguousarray(
            bufs.materials, np.float32)).to(self.device)
        r = self.renderer
        r.scene = dataclasses.replace(r.scene, materials=new_m)
        if r.scene_t is not None:
            r.scene_t = dataclasses.replace(r.scene_t, materials=new_m)
        return True

    def editor_set_light(self, index: int, **params) -> bool:
        """Mutate a light (brightness, color, position, ...). Shadow-map
        caches invalidate so caster edits re-render their maps."""
        if not (0 <= index < len(self.lights)):
            return False
        light = self.lights[index]
        for key, val in params.items():
            if not hasattr(light, key):
                return False
            setattr(light, key, val)
        self.loop.static_maps = None
        return True

    def editor_set_object_transform(self, item_name: str, position=None,
                                    rotation=None, scale=None) -> bool:
        """Move/rotate/scale a scene object by DrawItem name; per-frame
        world matrices rebuild from the transforms, so the edit is live."""
        if self.scene_buffers is None:
            return False
        hit = False
        for it in self.scene_buffers.items:
            if it.name == item_name:
                if position is not None:
                    it.transform.position = np.asarray(position, np.float32)
                if rotation is not None:
                    it.transform.rotation = np.asarray(rotation, np.float32)
                if scale is not None:
                    it.transform.scale = np.asarray(scale, np.float32)
                hit = True
        if hit:
            self.loop.static_maps = None   # geometry moved
        return hit

    def _log_periodic_stats(self) -> None:
        """Frame pacing log every 4 seconds (VQEngine_Simulation.cpp:47-55)
        + FRenderStats (the F2 profiler window's data)."""
        now = time.perf_counter()
        if now - self._last_stats_log < 4.0 or not self._frame_times:
            return
        ft = np.asarray(self._frame_times)
        s = self.renderer.stats
        log.info(
            f"[profiler] frame {self.num_ticks}: "
            f"{1.0 / max(ft.mean(), 1e-9):.1f} FPS ({ft.mean()*1e3:.2f} ms avg, "
            f"{ft.max()*1e3:.2f} ms max) | tris {s.num_draws} | "
            f"frames rendered {s.num_frames_rendered}")
        self._last_stats_log = now

    def tick(self, dt: float = 1 / 60):
        """One simulation tick: events -> input -> update -> render
        (SimulationThread_Tick, VQEngine_Simulation.cpp:88-105); the frame
        renders without readback."""
        with trace.tick():
            return self._tick(dt)

    def _tick(self, dt: float):
        t0 = time.perf_counter()
        with trace.span("vq.tick.events"):
            # finalize async loads whose host work completed
            if self._scene_future is not None:
                self.poll_scene_loading()
            if self._env_future is not None and self._env_future.done():
                eq = self._env_future.result()
                self._env_future = None
                self.environment = self._build_environment_maps(eq)
            self.handle_events()
            loaded = self.scene_buffers is not None
            if loaded:
                self.handle_engine_input(dt)
        if not loaded:
            return self._last_output     # still LOADING: nothing to render
        start = self._tick_clock.start()
        if self.scene_update_hook is not None:
            with trace.span("vq.tick.hook"):
                self.scene_update_hook(self, dt)
        out = self.render_frame(readback=False)
        with trace.span("vq.tick.contexts"):
            self._render_extra_contexts()
        self.input.post_update()
        self.num_ticks += 1
        ms = self._tick_clock.stop(start)
        if ms is not None:
            self.renderer.stats.last_frame_ms = ms
        # frame-rate limiter (Settings.h:47, VQEngine_Update.cpp:343-368)
        if self.gfx.MaxFrameRate > 0:
            target = 1.0 / self.gfx.MaxFrameRate
            elapsed = time.perf_counter() - t0
            if elapsed < target:
                time.sleep(target - elapsed)
        self._frame_times.append(time.perf_counter() - t0)
        self._log_periodic_stats()
        return out

    # ------------------------------------------------------------------
    def _check_frame(self, last: FrameOutput) -> int:
        """The checks of every 16th frame (the debug-layer/device-removed
        analog, VQEngine_Render.cpp:386-416): a non-finite frame -> 2, a
        bin overflow (silently missing geometry) -> 3; an adaptive pass
        past its cap, or shed while demand existed, is logged."""
        ldr = last.ldr
        finite = (bool(torch.isfinite(ldr).all()) if isinstance(ldr, torch.Tensor)
                  else bool(np.isfinite(ldr).all()))
        if not finite:
            log.error(f"non-finite pixels at frame {self.num_ticks}")
            return 2
        if last.overflow is not None:
            ov = _host(last.overflow)
            if int(ov.sum()) != 0:
                log.error(f"raster bin overflow at frame {self.num_ticks}: "
                          f"dropped (fine, row, global) pairs = {ov.tolist()}")
                return 3
        for k, v in (last.saturation or {}).items():
            frac = float(v)
            if frac > 1.0:
                log.warning(
                    f"adaptive cap saturated at frame {self.num_ticks}: {k} "
                    f"demand = {frac:.2f}x capacity (quality degraded on "
                    f"the overflow pixels)")
            elif (frac == 0.0 and not k.endswith("_demand")
                  and float(last.saturation.get(k + "_demand", 0.0)) > 1.0):
                # the ladder retreated to its all-False rung while real
                # demand existed: the adaptive pass ran on nothing
                log.warning(f"adaptive pass shed everything at frame "
                            f"{self.num_ticks}: {k} = 0 with over-cap demand")
        return 0

    def run(self) -> int:
        """Main loop. With -Test, runs NumAutomatedTestFrames frames and
        exits 0 on success (the Scripts/TestVQE.bat contract): 1 when the
        scene does not load, 2 on a non-finite frame, 3 on a bin overflow.
        Writes loading.png, the last frame with the profiler HUD
        ({scene}_frame{NNNN}.png), each render context ({scene}_{name}.png)
        and, with bHDR, the last frame's HDR10 encode ({scene}_hdr10.png)."""
        scene = self.settings.SceneName or self.settings.StartupScene
        # loading screen (LoadingScreenRendering.cpp behavior)
        out_dir = Path(self.settings.OutputDir)
        try:
            from ..render.hud import loading_screen
            ls = loading_screen(self.settings.Width, self.settings.Height,
                                data_dirs=self.data_dirs)
            out_dir.mkdir(parents=True, exist_ok=True)
            write_png(out_dir / "loading.png", ls)
        except Exception:  # noqa: BLE001 — cosmetic only
            pass
        if not self.start_loading_scene(scene):
            return 1
        n_frames = (self.settings.NumAutomatedTestFrames
                    if self.settings.bAutomatedTestRun else 1)
        t0 = time.perf_counter()
        last = None
        try:
            for i in range(n_frames):
                last = self.tick()
                if (i & 15) == 15 and last is not None:
                    rc = self._check_frame(last)
                    if rc:
                        return rc
        except Exception as e:  # noqa: BLE001
            log.error(f"frame {self.num_ticks} failed: {e}")
            raise
        # readback + dump the final frame
        img = _host(last.ldr)
        if not np.isfinite(img).all():
            log.error("non-finite pixels in final frame")
            return 2
        elapsed = time.perf_counter() - t0
        log.info(f"{n_frames} frames in {elapsed:.3f}s "
                 f"({elapsed/max(1,n_frames)*1e3:.2f} ms/frame avg, "
                 f"{self.settings.Width}x{self.settings.Height})")
        out_dir.mkdir(parents=True, exist_ok=True)
        # stamp the profiler HUD (the F2 window) onto the dumped frame
        try:
            from ..render.hud import draw_profiler_hud
            ft = (np.asarray(self._frame_times) if self._frame_times
                  else np.asarray([elapsed]))
            img = draw_profiler_hud(img, {
                "fps": 1.0 / max(float(ft.mean()), 1e-9),
                "ms": float(ft.mean()) * 1e3,
                "tris": self.renderer.stats.num_draws,
                "scene": self.scene_name,
                "frame": self.num_ticks,
            })
        except Exception:  # noqa: BLE001 — cosmetic only
            pass
        frame_path = out_dir / f"{self.scene_name}_frame{self.num_ticks:04d}.png"
        write_png(frame_path, img)
        log.info(f"wrote {frame_path}")
        # secondary render contexts present to their own files (the
        # debug window's swapchain present)
        for cname, ctx in self._render_contexts.items():
            if ctx["last"] is not None:
                p = out_dir / f"{self.scene_name}_{cname}.png"
                write_png(p, _host(ctx["last"].ldr))
                log.info(f"wrote {p} (render context '{cname}')")
        if self.gfx.bHDR and last.hdr is not None:
            # HDR10 output (the swapchain-format analog, SwapChain.h:76-99
            # color spaces): the last frame's pre-tonemap image re-encoded
            # to ST2084 at the display profile's brightness clamped by the
            # environment's MaxCLL (the values the reference feeds into the
            # swapchain's HDR metadata, SetHDRMetaData)
            brightness = self.hdr_display_brightness()
            enc = pp.tonemap(last.hdr, cs.DISPLAY_CURVE_ST2084,
                             apply_gamma=True,
                             display_reference_brightness=brightness)
            hdr_path = out_dir / f"{self.scene_name}_hdr10.png"
            write_png(hdr_path, _host(enc))
            log.info(f"wrote {hdr_path} (ST2084/PQ @ {brightness:.0f} nits, "
                     f"profile '{self.settings.HDRProfile}', "
                     f"MaxCLL {self._env_max_cll:.0f})")
        self.state = EAppState.EXITING
        return 0
