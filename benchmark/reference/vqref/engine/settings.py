"""Engine / graphics settings — counterpart of
``vqengine_tpu/engine/settings.py`` (reference Settings.h: FGraphicsSettings,
FEngineSettings, FWindowSettings) and its 3-layer override chain: compiled
defaults <- EngineSettings.ini <- command line (reference
VQEngine_Main.cpp:153-247, each INI/CLI value carrying an explicit
bOverride* flag in FStartupParameters); the scene mapping, environment-map
presets and HDR display profiles of Data/*.ini; and the render flags the
engine's frame derives from the graphics settings (render_flags). A
verbatim copy apart from its imports and render_flags."""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

from ..utils.ini import parse_bool, parse_ini


@dataclass
class FGraphicsSettings:
    # reference Settings.h:39-53
    bVsync: bool = False
    bUseTripleBuffering: bool = True
    bAntiAliasing: bool = True          # MSAA 4x when on
    bUseSeparateSubmissionQueue: bool = True
    bEnableAsyncCompute: bool = True    # maps to XLA async scheduling knobs
    bEnableAsyncCopy: bool = True
    RenderScale: float = 1.0
    MaxFrameRate: int = 0               # 0 = unlimited, -1 = refresh * 1.15
    bHDR: bool = True
    Reflections: int = 1                # 0 off, 1 SSR on
    EnvironmentMapResolution: int = 512
    bAmbientOcclusion: bool = True      # FFX-CACAO-class SSAO
    # motion vectors feed the DNSR temporal reprojection; on by default so
    # reflections reproject under camera motion like the reference
    # (ScreenSpaceReflections.h:104-171 reproject pass)
    bMotionVectors: bool = True
    bDrawLightBounds: bool = True       # light gizmo meshes (Unlit.hlsl)
    bDrawBoundingBoxes: bool = False    # wireframe AABBs (F-key toggle)
    ShadowFilter: str = "esm"           # esm | pcf (Lighting.hlsl PCF path)
    SSAOQuality: str = "medium"         # low | medium | high (CACAO presets)


def render_flags(gfx: FGraphicsSettings) -> dict:
    """The render flags of VQRendererTorch.render that the engine's frame
    takes from its graphics settings (the reference's engine.render_frame):
    MSAA, SSAO and its preset, motion vectors, SSR, the shadow filter and
    the render scale (below 1: render smaller, FSR1 to the display size).
    The frame's state (shadow maps, the SSR history, the dynamic item set)
    is the caller's."""
    return {"msaa": gfx.bAntiAliasing,
            "enable_ssao": gfx.bAmbientOcclusion,
            "ssao_quality": gfx.SSAOQuality,
            "enable_motion_vectors": gfx.bMotionVectors,
            "enable_ssr": bool(gfx.Reflections),
            "shadow_filter": gfx.ShadowFilter,
            "render_scale": gfx.RenderScale}


@dataclass
class FEngineSettings:
    Width: int = 1600
    Height: int = 900
    DisplayMode: str = "Windowed"       # headless on TPU; kept for parity
    PreferredDisplay: int = 0
    StartupScene: int = 0
    bAutomatedTestRun: bool = False
    NumAutomatedTestFrames: int = 100   # reference Main.cpp:78 default
    bLogConsole: bool = True
    bLogFile: bool = False
    LogFilePath: str = "vqengine_tpu.log"
    SceneName: str = ""                 # -Scene override by name
    OutputDir: str = "out"              # where headless frames are dumped
    # HDR display profile name (Data/HDRDisplayProfiles.ini section) that
    # drives the ST2084 output encode — the reference passes the matched
    # monitor's profile into SetHDRMetaData (SwapChain.h:76-99)
    HDRProfile: str = "Reference1000"


@dataclass
class FStartupParameters:
    """Parsed CLI with per-field override flags, mirroring the reference's
    FStartupParameters (VQEngine_Main.cpp:153-247)."""
    overrides: dict[str, Any] = field(default_factory=dict)

    def set(self, key: str, value: Any) -> None:
        self.overrides[key] = value


ENGINE_KEYS = {"Width", "Height", "DisplayMode", "PreferredDisplay", "StartupScene"}
GRAPHICS_KEYS = {
    "bVsync", "bUseTripleBuffering", "bAntiAliasing", "RenderScale",
    "MaxFrameRate", "bHDR", "Reflections", "EnvironmentMapResolution",
    "ShadowFilter", "SSAOQuality",
}


def load_engine_settings(
    data_dir: str | Path | None = None,
    startup: FStartupParameters | None = None,
) -> tuple[FEngineSettings, FGraphicsSettings]:
    """Defaults <- Data/EngineSettings.ini <- CLI overrides.

    INI schema matches the reference's Data/EngineSettings.ini:
    [Graphics] VSync/RenderScale/TripleBuffer/AntiAliasing/Reflections/
    MaxFrameRate/HDR/EnvironmentMapResolution; [Engine] Width/Height/
    DisplayMode/PreferredDisplay/Scene.
    """
    eng = FEngineSettings()
    gfx = FGraphicsSettings()

    ini_path = None
    if data_dir is not None:
        p = Path(data_dir) / "EngineSettings.ini"
        if p.is_file():
            ini_path = p
    if ini_path is not None:
        ini = parse_ini(ini_path)
        g = ini.get("Graphics", {})
        if "VSync" in g: gfx.bVsync = parse_bool(g["VSync"])
        if "RenderScale" in g: gfx.RenderScale = float(g["RenderScale"])
        if "TripleBuffer" in g: gfx.bUseTripleBuffering = parse_bool(g["TripleBuffer"])
        if "AntiAliasing" in g: gfx.bAntiAliasing = parse_bool(g["AntiAliasing"])
        if "Reflections" in g: gfx.Reflections = int(g["Reflections"])
        if "MaxFrameRate" in g: gfx.MaxFrameRate = int(g["MaxFrameRate"])
        if "HDR" in g: gfx.bHDR = parse_bool(g["HDR"])
        if "EnvironmentMapResolution" in g:
            gfx.EnvironmentMapResolution = int(g["EnvironmentMapResolution"])
        e = ini.get("Engine", {})
        if "Width" in e: eng.Width = int(e["Width"])
        if "Height" in e: eng.Height = int(e["Height"])
        if "DisplayMode" in e: eng.DisplayMode = e["DisplayMode"]
        if "PreferredDisplay" in e: eng.PreferredDisplay = int(e["PreferredDisplay"])
        if "Scene" in e: eng.StartupScene = int(e["Scene"])
        if "HDRProfile" in e: eng.HDRProfile = e["HDRProfile"]

    if startup is not None:
        for k, v in startup.overrides.items():
            if hasattr(eng, k):
                setattr(eng, k, v)
            elif hasattr(gfx, k):
                setattr(gfx, k, v)
            else:
                raise KeyError(f"unknown settings override: {k}")
    return eng, gfx


def load_scene_mapping(data_dir: str | Path) -> dict[str, int]:
    """Parse Scenes.ini [SceneMapping] name -> index (reference Data/Scenes.ini)."""
    p = Path(data_dir) / "Scenes.ini"
    if not p.is_file():
        return {}
    ini = parse_ini(p)
    return {k: int(v) for k, v in ini.get("SceneMapping", {}).items()}


def load_environment_map_presets(data_dir: str | Path) -> dict[str, dict[str, str]]:
    """Parse EnvironmentMaps.ini presets: name -> {Path, MaxCLL}."""
    p = Path(data_dir) / "EnvironmentMaps.ini"
    if not p.is_file():
        return {}
    return {k: dict(v) for k, v in parse_ini(p).items() if k}


def hdr_reference_brightness(profiles: dict[str, dict[str, float]],
                             profile_name: str, max_cll: float = 0.0,
                             default: float = 200.0) -> float:
    """ST2084 encode reference brightness (nits): the selected display
    profile's MaxBrightness clamped by the content's MaxCLL — the same
    two values the reference feeds into swapchain HDR metadata
    (SwapChain.h:76-99; Data/HDRDisplayProfiles.ini + EnvironmentMaps.ini)."""
    prof = profiles.get(profile_name, {})
    brightness = float(prof.get("MaxBrightness", default))
    if max_cll > 0:
        brightness = min(brightness, max_cll)
    return brightness


def load_hdr_display_profiles(data_dir: str | Path) -> dict[str, dict[str, float]]:
    """Parse HDRDisplayProfiles.ini: monitor name -> {MinBrightness,
    MaxBrightness} (reference Data/HDRDisplayProfiles.ini; drives the
    tonemapper's DisplayReferenceBrightnessLevel)."""
    p = Path(data_dir) / "HDRDisplayProfiles.ini"
    if not p.is_file():
        return {}
    out = {}
    for name, kv in parse_ini(p).items():
        if not name:
            continue
        out[name] = {k: float(v) for k, v in kv.items()}
    return out
