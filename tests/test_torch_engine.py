"""The port's engine shell (vqengine_tpu_torch.engine.engine.VQEngineTorch
and ``python -m vqengine_tpu_torch``) on the CPU.

- The host modules (CLI, settings and the Data/*.ini readers, events,
  input, the HUD and the VQUI panels) against the JAX package's on the same
  inputs: settings equal, HUD and panel images bitwise.
- tests/test_engine.py, test_ui.py and test_config.py on the port, at their
  sizes (HelloCube and HelloTriangle at 96x64 and 48x48; SSAO, MSAA and
  SSR off). Where a test loads a level with an environment (Default), the
  engine prefilters it at small table sizes: at the engine's sizes the
  build takes most of a minute on one CPU core.
- An engine tick against the port's own FrameLoop on the same state,
  bitwise (RenderScale 0.75: FSR1 on every tick); the ticks render without
  readback. The frames of both are held against the reference elsewhere.
- The -Test run: exit code 0 and the reference's file names; the HDR10
  encode against the reference's tonemap run op by op on the port's hdr;
  no run without a card unless the CPU is asked for; a run in a fresh
  process imports neither jax nor the JAX package.

The reference's VQEngineTPU is never run here (it compiles whole frames).
"""
import dataclasses
import functools
import subprocess
import sys
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vqengine_tpu.ops._backend  # noqa: F401  (the reference's matmul precision)
from vqengine_tpu.engine import cli as jcli
from vqengine_tpu.engine import events as jev
from vqengine_tpu.engine import input as jinput
from vqengine_tpu.engine import settings as jset
from vqengine_tpu.ops import colorspace as jcs
from vqengine_tpu.ops import postprocess as jpp
from vqengine_tpu.render import hud as jhud
from vqengine_tpu.render import ui as jui
from vqengine_tpu_torch.__main__ import main
from vqengine_tpu_torch.engine import events as ev
from vqengine_tpu_torch.engine import settings as tset
from vqengine_tpu_torch.engine.cli import parse_command_line
from vqengine_tpu_torch.engine.engine import EAppState, VQEngineTorch
from vqengine_tpu_torch.engine.frame_loop import FrameLoop
from vqengine_tpu_torch.engine.input import Input
from vqengine_tpu_torch.engine.scene_load import load_scene
from vqengine_tpu_torch.engine.settings import (
    FStartupParameters, hdr_reference_brightness, load_engine_settings,
    load_environment_map_presets, load_hdr_display_profiles,
    load_scene_mapping)
from vqengine_tpu_torch.ops import colorspace as tcs
from vqengine_tpu_torch.ops import postprocess as tpp
from vqengine_tpu_torch.render import hud as thud
from vqengine_tpu_torch.render import ui
from vqengine_tpu_torch.render.renderer import VQRendererTorch
from vqengine_tpu_torch.utils.image_io import read_png

torch.set_num_threads(1)

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parent.parent
# the reference's config files, as the repository ships them
REPO_DATA = ROOT / "Data"
# the environment tables of a test engine (graph.build_environment's)
SMALL_ENV = dict(diffuse_size=4, specular_base=8, lut_size=16)


def host(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def make_engine(scene="HelloCube", w=96, h=64):
    e = VQEngineTorch(startup=parse_command_line(
        [f"-W={w}", f"-H={h}", f"-Scene={scene}"]), device=CPU)
    e.gfx.bAmbientOcclusion = False
    e.gfx.bAntiAliasing = False
    e.gfx.bDrawLightBounds = False  # keep picking tests deterministic
    e.gfx.Reflections = 0
    e._build_environment_maps = functools.partial(
        VQEngineTorch._build_environment_maps, e, **SMALL_ENV)
    return e


def press(e, key):
    """Key tap: down + tick + up (is_key_triggered requires a fresh press,
    so repeated taps need the release in between like real input)."""
    e.input.on_key_down(key)
    e.tick()
    e.input.on_key_up(key)


# ---------------------------------------------------------------------------
# the host modules against the JAX package's
# ---------------------------------------------------------------------------

ARGVS = [["-Test", "-TestFrames=250"],
         ["-W=1920", "-Height=1080", "-VSync=false", "-AA", "-HDR=0"],
         ["-MaxFPS=Auto", "-Scene=Sponza", "-OutputDir=x", "-LogFile=a.log"],
         ["-Fullscreen", "-DoubleBuffering", "-maxframerate=30", "junk", "-w"]]


@pytest.mark.parametrize("argv", ARGVS)
def test_cli_and_settings_match_reference(argv):
    """parse_command_line and the override chain (compiled defaults <- the
    repo's EngineSettings.ini <- the command line) give equal settings."""
    p, r = parse_command_line(argv), jcli.parse_command_line(argv)
    assert p.overrides == r.overrides
    for data_dir in (None, REPO_DATA):
        pe, pg = load_engine_settings(data_dir, p)
        re_, rg = jset.load_engine_settings(data_dir, r)
        assert dataclasses.asdict(pe) == dataclasses.asdict(re_)
        assert dataclasses.asdict(pg) == dataclasses.asdict(rg)


def test_data_inis_match_reference():
    assert load_scene_mapping(REPO_DATA) == jset.load_scene_mapping(REPO_DATA)
    assert (load_environment_map_presets(REPO_DATA)
            == jset.load_environment_map_presets(REPO_DATA))
    profiles = load_hdr_display_profiles(REPO_DATA)
    assert profiles == jset.load_hdr_display_profiles(REPO_DATA)
    for name, cll in (("Reference1000", 0.0), ("Reference1000", 340.0),
                      ("Desktop400", 26293.0), ("nope", 0.0)):
        assert (hdr_reference_brightness(profiles, name, cll)
                == jset.hdr_reference_brightness(profiles, name, cll))


def test_events_and_input_match_reference():
    """The same key, mouse and event sequence through both."""
    sides = []
    for mod_in, mod_ev in ((Input, ev), (jinput.Input, jev)):
        i, q = mod_in(), mod_ev.BufferedEventQueue()
        log = []
        for k in ("W", "d", "Q"):
            i.on_key_down(k)
        i.on_mouse_move(3.0, -2.0)
        i.on_mouse_click(5, 6, 1)
        log.append((sorted(k for k in "wdqx" if i.is_key_triggered(k)),
                    i.wasd_vector().tolist(), i.clicks(), i.mouse_dx))
        i.post_update()
        i.on_key_up("d")
        log.append((i.is_key_down("w"), i.is_key_triggered("w"),
                    i.is_key_released("d"), i.wasd_vector().tolist()))
        q.push(mod_ev.WindowResizeEvent(128, 96))
        q.push(mod_ev.KeyDownEvent("a"))
        log.append([dataclasses.asdict(e) for e in q.swap_and_drain()])
        log.append(q.swap_and_drain())
        sides.append(log)
    assert sides[0] == sides[1]


def test_hud_matches_reference():
    """stamp_text, draw_profiler_hud and loading_screen, bitwise."""
    img = np.random.default_rng(3).uniform(0, 1, (64, 96, 3)).astype(np.float32)
    stats = {"fps": 59.94, "ms": 16.683, "tris": 123456, "scene": "Sponza",
             "frame": 16}
    np.testing.assert_array_equal(
        thud.stamp_text(img, "FPS 60.0 [x] = 3%", 2, 3, scale=2),
        jhud.stamp_text(img, "FPS 60.0 [x] = 3%", 2, 3, scale=2))
    np.testing.assert_array_equal(thud.draw_profiler_hud(img, stats),
                                  jhud.draw_profiler_hud(img, stats))
    np.testing.assert_array_equal(
        thud.loading_screen(96, 64, data_dirs=[REPO_DATA]),
        jhud.loading_screen(96, 64, data_dirs=[REPO_DATA]))


def test_ui_panels_match_reference():
    """The four VQUI panels, built on the same engine state (a stand-in
    engine for each side) and drawn, bitwise."""
    img = np.random.default_rng(4).uniform(0, 1, (128, 256, 3)).astype(np.float32)

    def fake(gfx_cls, stats_cls):
        import types
        return types.SimpleNamespace(
            _frame_times=[0.016, 0.018], num_ticks=42, scene_name="Default",
            renderer=types.SimpleNamespace(stats=stats_cls(
                num_frames_rendered=42, num_draws=9000, last_frame_ms=17.5)),
            gfx=gfx_cls(), draw_mode=3, selected_object=2,
            editor_material_of_object=lambda oid: "Stone",
            editor_get_material=lambda name, key: 0.25)

    from vqengine_tpu.render.renderer import FRenderStats as JStats
    from vqengine_tpu_torch.render.renderer import FRenderStats as TStats
    te = fake(tset.FGraphicsSettings, TStats)
    je = fake(jset.FGraphicsSettings, JStats)
    for build, jbuild in ((ui.build_profiler_panel, jui.build_profiler_panel),
                          (ui.build_settings_panel, jui.build_settings_panel),
                          (ui.build_editor_panel, jui.build_editor_panel)):
        tp, jp = build(te), jbuild(je)
        tp.cursor = jp.cursor = tp.interactive_rows()[0] if tp.interactive_rows() else 0
        np.testing.assert_array_equal(ui.draw_panel(img, tp), jui.draw_panel(img, jp))
    np.testing.assert_array_equal(
        ui.draw_panel(img, ui.build_controls_panel()),
        jui.draw_panel(img, jui.build_controls_panel()))


# ---------------------------------------------------------------------------
# tests/test_engine.py on the port
# ---------------------------------------------------------------------------

class TestInput:
    def test_trigger_vs_held(self):
        i = Input()
        i.on_key_down("W")
        assert i.is_key_triggered("w") and i.is_key_down("w")
        i.post_update()
        assert not i.is_key_triggered("w") and i.is_key_down("w")
        i.on_key_up("w")
        assert i.is_key_released("w") and not i.is_key_down("w")

    def test_wasd(self):
        i = Input()
        i.on_key_down("w")
        i.on_key_down("d")
        np.testing.assert_allclose(i.wasd_vector(), [1, 0, 1])


class TestEventQueue:
    def test_double_buffered(self):
        q = ev.BufferedEventQueue()
        q.push(ev.KeyDownEvent("a"))
        q.push(ev.KeyDownEvent("b"))
        assert len(q.swap_and_drain()) == 2
        assert q.swap_and_drain() == []


class TestEngine:
    def test_state_machine_and_tick(self):
        e = make_engine()
        assert e.state == EAppState.INITIALIZING
        assert e.start_loading_scene("HelloCube")
        assert e.state == EAppState.SIMULATING
        out = e.tick()
        assert out.ldr.shape[0] == 64

    def test_resize_event(self):
        e = make_engine()
        e.start_loading_scene("HelloTriangle")
        e.events.push(ev.WindowResizeEvent(128, 96))
        e.tick()
        assert e.settings.Width == 128
        out = e.tick()
        assert host(out.ldr).shape[:2] == (96, 128)

    def test_camera_switch_key(self):
        e = make_engine(scene="Default")
        assert e.start_loading_scene("Default")
        assert len(e.cameras) >= 2
        e.events.push(ev.KeyDownEvent("2"))
        e.handle_events()
        e.handle_engine_input(1 / 60)
        assert e.active_camera == 1

    def test_pick_via_click(self):
        e = make_engine()
        e.start_loading_scene("HelloCube")
        e.tick()
        # the object id at the center: the cube (object 0)
        assert e.pick(48, 32) == 0
        assert e.pick(2, 2) == -1

    def test_automated_run_exit_code(self, tmp_path):
        """main(-Test) on the CPU: exit code 0, the reference's file names."""
        rc = main(["-Test", "-TestFrames=2", "-W=96", "-H=64",
                   "-Scene=HelloTriangle", f"-OutputDir={tmp_path}"],
                  device=CPU)
        assert rc == 0
        assert {p.name for p in Path(tmp_path).glob("*.png")} == {
            "loading.png", "HelloTriangle_frame0002.png",
            "HelloTriangle_hdr10.png"}


class TestDebugViews:
    def test_draw_mode_and_outline_and_magnifier(self):
        e = make_engine()
        e.start_loading_scene("HelloCube")
        e.tick()
        lit = host(e._last_output.ldr).copy()

        # cycle draw mode via the 'v' binding -> depth view differs from lit
        e.events.push(ev.KeyDownEvent("v"))
        e.tick()
        e.events.push(ev.KeyUpEvent("v"))
        assert e.draw_mode == 1
        depth_view = host(e._last_output.ldr)
        assert abs(depth_view - lit).mean() > 1e-3
        # depth view is grayscale
        assert abs(depth_view[..., 0] - depth_view[..., 1]).max() < 1e-5

        # click the cube -> selection outline appears in LIT mode
        e.draw_mode = 0
        e.events.push(ev.MouseClickEvent(48, 32, 0))
        e.tick()
        assert e.selected_object == 0
        e.tick()
        outlined = host(e._last_output.ldr)
        assert abs(outlined - lit).mean() > 1e-5

        # magnifier lens
        e.selected_object = -1
        e.magnifier_on = True
        e.tick()
        assert abs(host(e._last_output.ldr) - lit).mean() > 1e-5


class TestAsyncLoading:
    def test_async_scene_load_keeps_ticking(self):
        """start_loading_scene_async returns immediately; ticks while the
        host load runs are safe no-ops, and a later tick finalizes the
        device upload."""
        e = make_engine()
        assert e.start_loading_scene_async("HelloCube")
        assert e.state == EAppState.LOADING
        deadline = time.time() + 60
        while e.state != EAppState.SIMULATING and time.time() < deadline:
            e.tick()
        assert e.state == EAppState.SIMULATING
        out = e.tick()
        assert out is not None and np.isfinite(host(out.ldr)).all()

    def test_async_env_switch_nonblocking(self):
        """A SetEnvironmentMapEvent decodes on the worker pool; the next
        ticks keep rendering and eventually swap the environment."""
        e = make_engine()
        assert e.start_loading_scene("HelloCube")
        e.events.push(ev.SetEnvironmentMapEvent("missing-preset"))
        e.tick()   # consumes the event, dispatches the async decode
        deadline = time.time() + 60
        while e._env_future is not None and time.time() < deadline:
            e.tick()
        # fell back to the procedural sky -> environment present
        assert e.environment is not None


class TestEditor:
    def test_material_live_edit(self):
        e = make_engine(scene="HelloCube")
        assert e.start_loading_scene("HelloCube")
        img0 = host(e.tick().ldr)
        changed = False
        for n in e.scene_buffers.material_names:
            if e.editor_set_material(n, diffuse=(1.0, 0.0, 0.0),
                                     roughness=0.9):
                changed = True
        assert changed
        img1 = host(e.tick().ldr)
        assert np.abs(img1 - img0).max() > 0.05
        assert not e.editor_set_material("no-such-material", roughness=0.5)

    def test_light_and_object_edit(self):
        e = make_engine(scene="HelloCube")
        assert e.start_loading_scene("HelloCube")
        img0 = host(e.tick().ldr)
        assert e.editor_set_light(0, brightness=0.05)
        img1 = host(e.tick().ldr)
        assert img1.mean() < img0.mean()  # dimmer
        name = e.scene_buffers.items[0].name
        assert e.editor_set_object_transform(name, position=(50.0, 50.0, 50.0))
        img2 = host(e.tick().ldr)
        assert np.abs(img2 - img1).max() > 0.02  # object moved off-frame
        assert not e.editor_set_object_transform("no-such-item")


class TestRenderContexts:
    def test_second_context_renders_own_resolution(self):
        e = make_engine()
        e.start_loading_scene("HelloCube")
        e.create_render_context("debug", 48, 48, hdr10=False)
        e.tick()
        out = e.context_output("debug")
        assert out is not None
        ldr = host(out.ldr)
        assert ldr.shape == (48, 48, 3) and np.isfinite(ldr).all()
        assert host(e._last_output.ldr).shape[:2] == (64, 96)
        e.destroy_render_context("debug")
        e.tick()
        assert e.context_output("debug") is None


# ---------------------------------------------------------------------------
# tests/test_ui.py on the port
# ---------------------------------------------------------------------------

class TestWidgets:
    def test_cursor_skips_labels(self):
        p = ui.Panel("t", [ui.Widget("a"),
                           ui.Widget("b", "check", lambda: True, lambda v: None),
                           ui.Widget("c"),
                           ui.Widget("d", "check", lambda: False, lambda v: None)])
        p.move_cursor(1)
        assert p.cursor == 1
        p.move_cursor(1)
        assert p.cursor == 3
        p.move_cursor(1)
        assert p.cursor == 1            # wraps, never lands on a label

    def test_adjust_kinds(self):
        state = {"b": False, "c": 0, "s": 0.5}
        chk = ui.Widget("b", "check", lambda: state["b"],
                        lambda v: state.update(b=v))
        cho = ui.Widget("c", "choice", lambda: state["c"],
                        lambda v: state.update(c=v), choices=["x", "y", "z"])
        sld = ui.Widget("s", "slider", lambda: state["s"],
                        lambda v: state.update(s=v), step=0.3, lo=0.0, hi=1.0)
        chk.adjust(1)
        assert state["b"] is True
        cho.adjust(-1)
        assert state["c"] == 2
        sld.adjust(1)
        sld.adjust(1)
        assert abs(state["s"] - 1.0) < 1e-6    # clamped at hi
        assert cho.value_str() == "< z >"
        assert chk.value_str() == "[x]"

    def test_draw_panel_writes_pixels(self):
        img = np.zeros((64, 128, 3), np.float32)
        p = ui.Panel("TEST", [ui.Widget("row one"),
                              ui.Widget("toggle", "check", lambda: True,
                                        lambda v: None)])
        out = ui.draw_panel(img, p)
        assert out.shape == img.shape
        assert (out != img).any()
        assert out[20, 30].sum() > 0


class TestEnginePanels:
    def test_f3_settings_toggle_writes_through(self):
        e = make_engine()
        e.start_loading_scene("HelloCube")
        e.tick()
        base = host(e._last_output.ldr).copy()
        press(e, "f3")
        assert e.ui_panel == 3
        with_panel = host(e._last_output.ldr)
        assert (np.abs(with_panel - base) > 0.01).any(), "panel invisible"
        # the first interactive row is the MSAA checkbox; toggle it on
        assert e.gfx.bAntiAliasing is False
        press(e, "enter")
        assert e.gfx.bAntiAliasing is True, "enter did not toggle MSAA"
        # navigate down to the SSAO row and toggle
        press(e, "down")
        press(e, "enter")
        assert e.gfx.bAmbientOcclusion is True
        press(e, "f3")
        assert e.ui_panel == 0

    def test_f2_profiler_and_f1_controls_render(self):
        e = make_engine()
        e.start_loading_scene("HelloCube")
        e.tick()
        for key, pid in (("f2", 2), ("f1", 1)):
            press(e, key)
            assert e.ui_panel == pid
            press(e, key)
            assert e.ui_panel == 0

    def test_f4_editor_adjusts_selected_material(self):
        e = make_engine()
        e.start_loading_scene("HelloCube")
        e.tick()
        e.selected_object = 0           # the cube, as if picked
        mat = e.editor_material_of_object(0)
        assert mat is not None
        r0 = e.editor_get_material(mat, "roughness")
        press(e, "f4")
        assert e.ui_panel == 4
        press(e, "right")                # the roughness slider, nudged up
        r1 = e.editor_get_material(mat, "roughness")
        assert abs(r1 - r0) > 1e-6, "editor slider did not write through"

    def test_shadow_filter_choice_invalidates_cached_maps(self):
        e = make_engine()
        e.start_loading_scene("HelloCube")
        e.tick()
        e.gfx.ShadowFilter = "pcf"
        e.tick()
        assert e._shadow_filter_cached in (None, "pcf")


# ---------------------------------------------------------------------------
# tests/test_config.py on the port
# ---------------------------------------------------------------------------

class TestCli:
    def test_test_frames(self):
        p = parse_command_line(["-Test", "-TestFrames=250"])
        assert p.overrides["bAutomatedTestRun"] is True
        assert p.overrides["NumAutomatedTestFrames"] == 250

    def test_resolution_and_flags(self):
        p = parse_command_line(["-W=1920", "-Height=1080", "-VSync=false", "-AA", "-HDR=0"])
        assert p.overrides["Width"] == 1920
        assert p.overrides["Height"] == 1080
        assert p.overrides["bVsync"] is False
        assert p.overrides["bAntiAliasing"] is True
        assert p.overrides["bHDR"] is False

    def test_maxfps_auto(self):
        assert parse_command_line(["-MaxFPS=Auto"]).overrides["MaxFrameRate"] == -1

    def test_scene(self):
        assert parse_command_line(["-Scene=Sponza"]).overrides["SceneName"] == "Sponza"


class TestSettingsOverrideChain:
    def test_defaults(self):
        eng, gfx = load_engine_settings(None)
        assert eng.Width == 1600 and eng.Height == 900
        assert gfx.bAntiAliasing is True

    def test_ini_layer_reference_file(self):
        eng, gfx = load_engine_settings(REPO_DATA)
        assert eng.Width == 1600 and eng.Height == 900
        assert gfx.bVsync is False
        assert gfx.EnvironmentMapResolution == 512
        assert gfx.bHDR is True

    def test_cli_overrides_ini(self):
        startup = FStartupParameters()
        startup.set("Width", 1280)
        startup.set("bHDR", False)
        eng, gfx = load_engine_settings(REPO_DATA, startup)
        assert eng.Width == 1280
        assert gfx.bHDR is False


class TestAuxIni:
    def test_scene_mapping(self):
        mapping = load_scene_mapping(REPO_DATA)
        assert mapping.get("Default") == 0
        assert mapping.get("Sponza") == 1
        assert mapping.get("Terrain") == 4

    def test_envmap_presets(self):
        presets = load_environment_map_presets(REPO_DATA)
        assert "ProceduralNoon" in presets
        assert presets["VeniceSunset"]["MaxCLL"] == "340"


class TestShippedDataInis:
    def test_engine_settings_file(self):
        eng, gfx = load_engine_settings(REPO_DATA)
        assert eng.Width == 1600 and eng.Height == 900
        assert gfx.EnvironmentMapResolution == 512
        assert gfx.ShadowFilter == "esm"
        assert eng.HDRProfile == "Reference1000"

    def test_envmap_presets_file(self):
        presets = load_environment_map_presets(REPO_DATA)
        assert float(presets["ProceduralNoon"]["MaxCLL"]) == 1500
        assert "SunPitch" in presets["ProceduralSunset"]
        assert presets["VeniceSunset"]["Path"].endswith(".hdr")

    def test_hdr_profiles_file(self):
        profiles = load_hdr_display_profiles(REPO_DATA)
        assert profiles["Reference1000"]["MaxBrightness"] == 1000
        assert profiles["Desktop400"]["MinBrightness"] == 0.1

    def test_hdr_reference_brightness(self):
        profiles = load_hdr_display_profiles(REPO_DATA)
        assert hdr_reference_brightness(profiles, "Reference1000") == 1000
        assert hdr_reference_brightness(profiles, "Reference1000", 340) == 340
        assert hdr_reference_brightness(profiles, "Desktop400", 26293) == 400
        assert hdr_reference_brightness(profiles, "nope") == 200.0


# ---------------------------------------------------------------------------
# the engine's frame, the -Test run
# ---------------------------------------------------------------------------

def test_tick_equals_frame_loop():
    """Three engine ticks (the engine's default flags but MSAA and SSR,
    RenderScale 0.75: 72x64 upscaled to 96x64 by FSR1, the camera moved by
    input on the second) against a FrameLoop over the port's own load of
    HelloCube with the same flags and camera: ldr, hdr, tri_id and ao
    bitwise. Neither reads the binning demand back (the bucket stays at
    the default capacity)."""
    e = make_engine()
    e.gfx.bAmbientOcclusion = True
    e.gfx.RenderScale = 0.75
    e.start_loading_scene("HelloCube")
    s = load_scene("HelloCube", 96, 64, draw_light_gizmos=False)
    r = VQRendererTorch(CPU)
    r.load_scene(s.buffers)
    loop = FrameLoop(r, s, 96, 64, tset.render_flags(e.gfx))
    calls = []
    for renderer in (e.renderer, r):
        renderer._update_pair_bucket = calls.append
    for frame in range(3):
        if frame == 1:
            e.input.on_key_down("w")
        out = e.tick()
        if frame == 1:
            e.input.on_key_up("w")
            loop.camera.update_first_person(
                1 / 60, np.array([0, 0, 0.01], np.float32), d_yaw_deg=0.0,
                d_pitch_deg=0.0)
        ref = loop.render()
        assert host(out.ldr).shape == (64, 96, 3)
        assert tuple(out.hdr.shape) == (64, 72, 3)
        for key in ("ldr", "hdr", "tri_id", "ao"):
            assert torch.equal(getattr(out, key), ref[key]), (frame, key)
    assert not calls and e.renderer.pair_bucket is None
    assert e.renderer.stats.num_frames_rendered == 3


def test_hdr10_png_matches_reference(tmp_path):
    """The -Test run's HDR10 file: the last frame's hdr through the
    port's ST.2084 tonemap at the display profile's brightness, within
    1e-6 of the reference's tonemap run op by op on the same hdr, and the
    PNG that frame quantized."""
    e = VQEngineTorch(["-Test", "-TestFrames=2", "-W=96", "-H=64",
                       "-Scene=HelloCube", f"-OutputDir={tmp_path}"], device=CPU)
    assert e.run() == 0
    hdr = e._last_output.hdr.numpy()
    b = e.hdr_display_brightness()
    assert b == 1000.0
    out = tpp.tonemap(torch.from_numpy(hdr), tcs.DISPLAY_CURVE_ST2084,
                      display_reference_brightness=b).numpy()
    ref = np.asarray(jpp.tonemap(jnp.asarray(hdr), jcs.DISPLAY_CURVE_ST2084,
                                 display_reference_brightness=b))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    png = read_png(tmp_path / "HelloCube_hdr10.png")[..., :3]
    np.testing.assert_array_equal(
        png, (np.clip(out, 0, 1) * 255.0 + 0.5).astype(np.uint8))
    assert png.std() > 0


def test_main_needs_a_card_unless_cpu_asked(monkeypatch, tmp_path):
    """Without a CUDA device and without the CPU asked for, the run fails
    (exit code 1) and writes no frame."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = main(["-Test", "-TestFrames=1", "-W=96", "-H=64",
               "-Scene=HelloTriangle", f"-OutputDir={tmp_path}"])
    assert rc != 0
    assert not list(Path(tmp_path).glob("*.png"))


_CLI_NO_JAX = """
import sys, torch
torch.set_num_threads(1)
from vqengine_tpu_torch.__main__ import main
rc = main(["-Test", "-TestFrames=2", "-W=96", "-H=64", "-Scene=HelloCube",
           "-OutputDir=" + sys.argv[1]], device=torch.device("cpu"))
assert rc == 0, rc
bad = [m for m in sys.modules
       if m in ("jax", "vqengine_tpu") or m.startswith(("jax.", "vqengine_tpu."))]
assert not bad, f"the port imported {bad}"
print("ok")
"""


def test_cli_run_imports_no_jax(tmp_path):
    """The -Test run of __main__ in a fresh process imports neither jax
    nor any module of the JAX package (test_torch_slice's
    test_port_renders_without_jax, for the engine shell)."""
    res = subprocess.run([sys.executable, "-c", _CLI_NO_JAX, str(tmp_path)],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().endswith("ok")
    assert (tmp_path / "HelloCube_frame0002.png").is_file()
