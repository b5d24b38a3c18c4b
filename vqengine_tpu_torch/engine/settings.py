"""Engine settings — the part of ``vqengine_tpu/engine/settings.py`` the
port needs so far: the graphics settings' compiled defaults
(FGraphicsSettings, reference Settings.h:39-53), the render flags the
engine derives from them (render_flags, as engine.render_frame passes them
to the renderer), and the environment-map presets of
Data/EnvironmentMaps.ini. (The engine settings, the override chain, scene
mapping and HDR display profiles come with the engine shell.)"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

from ..utils.ini import parse_ini


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
    MSAA, SSAO and its preset, motion vectors, SSR and the shadow filter.
    The frame's state (shadow maps, the SSR history, the dynamic item set)
    is the caller's; a RenderScale other than 1 (the FSR1 upscale) is not
    ported yet and raises."""
    if gfx.RenderScale != 1.0:
        raise NotImplementedError("render_flags: RenderScale != 1 (FSR1) is "
                                  "not ported yet")
    return {"msaa": gfx.bAntiAliasing,
            "enable_ssao": gfx.bAmbientOcclusion,
            "ssao_quality": gfx.SSAOQuality,
            "enable_motion_vectors": gfx.bMotionVectors,
            "enable_ssr": bool(gfx.Reflections),
            "shadow_filter": gfx.ShadowFilter}


def load_environment_map_presets(data_dir: str | Path) -> dict[str, dict[str, str]]:
    """Parse EnvironmentMaps.ini presets: name -> {Path, MaxCLL}."""
    p = Path(data_dir) / "EnvironmentMaps.ini"
    if not p.is_file():
        return {}
    return {k: dict(v) for k, v in parse_ini(p).items() if k}
