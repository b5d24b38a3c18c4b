"""Lights — counterpart of reference Source/Engine/Scene/Light.{h,cpp} and
the GPU-side structs in Shaders/LightingConstantBufferData.h.

Semantics preserved:
- Budgets: 100 point + 20 spot unshadowed; 5 point + 5 spot + 1 directional
  shadowed (LightingConstantBufferData.h:39-44).
- Spot default orientation +Z, directional default down (0,-1,0)
  (Light.cpp:91,114).
- Shadow projections: point/spot = 90deg perspective, directional = ortho
  ViewportX x ViewportY from distance along direction (Light.cpp:209-231).
- Attenuation: physically-based inverse-square with range cutoff
  (Lighting.hlsl:29-32, CalculatePointLightIllumination).

GPU light data is packed into flat numpy arrays (SoA) rather than C structs —
the device shading kernel consumes padded [N, K] tensors.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np

from ..utils import math3d as m3

# budgets (LightingConstantBufferData.h:39-44)
NUM_LIGHTS_POINT = 100
NUM_LIGHTS_SPOT = 20
NUM_SHADOWING_LIGHTS_POINT = 5
NUM_SHADOWING_LIGHTS_SPOT = 5


class ELightType(enum.IntEnum):
    POINT = 0
    SPOT = 1
    DIRECTIONAL = 2


class EMobility(enum.IntEnum):
    STATIC = 0
    STATIONARY = 1
    DYNAMIC = 2


@dataclass
class Light:
    type: ELightType = ELightType.POINT
    enabled: bool = True
    mobility: EMobility = EMobility.DYNAMIC
    position: np.ndarray = field(default_factory=lambda: np.zeros(3, dtype=np.float32))
    rotation: np.ndarray = field(default_factory=m3.quat_identity)
    color: np.ndarray = field(default_factory=lambda: np.ones(3, dtype=np.float32))
    brightness: float = 1.0
    range: float = 100.0
    # shadows
    casts_shadows: bool = False
    depth_bias: float = 0.001
    shadow_near: float = 0.1
    shadow_far: float = 100.0
    # spot
    inner_cone_deg: float = 20.0
    outer_cone_deg: float = 25.0
    # point
    attenuation: np.ndarray = field(default_factory=lambda: np.ones(3, dtype=np.float32))
    # directional
    viewport_x: int = 2048
    viewport_y: int = 2048
    distance_from_origin: float = 500.0
    # render mesh scale (gizmo)
    render_scale: float = 0.1

    # ------------------------------------------------------------------
    # direction vectors (Light.cpp:81-121)
    # ------------------------------------------------------------------
    def direction(self) -> np.ndarray:
        default = {
            ELightType.SPOT: np.array([0, 0, 1], dtype=np.float32),
            ELightType.DIRECTIONAL: np.array([0, -1, 0], dtype=np.float32),
            ELightType.POINT: np.array([0, 0, 1], dtype=np.float32),
        }[self.type]
        return m3.quat_rotate(self.rotation, default).astype(np.float32)

    # ------------------------------------------------------------------
    # shadow view-projection matrices (Light.cpp:133-231)
    # ------------------------------------------------------------------
    def view_projection(self, cube_face: int = 0) -> np.ndarray:
        proj = self._projection()
        if self.type == ELightType.POINT:
            view = cubemap_view_matrix(cube_face, self.position)
        elif self.type == ELightType.SPOT:
            view = self._spot_view()
        else:
            view = self._directional_view()
        return (proj @ view).astype(np.float32)

    def _projection(self) -> np.ndarray:
        if self.type in (ELightType.POINT, ELightType.SPOT):
            return m3.perspective_lh(np.pi / 2, 1.0, self.shadow_near, self.shadow_far)
        if self.viewport_x < 1:
            return m3.identity4()
        return m3.orthographic_lh(float(self.viewport_x), float(self.viewport_y),
                                  self.shadow_near, self.shadow_far)

    def _spot_view(self) -> np.ndarray:
        fwd = m3.quat_rotate(self.rotation, np.array([0, 0, 1], dtype=np.float32))
        up = m3.quat_rotate(self.rotation, np.array([0, 1, 0], dtype=np.float32))
        return m3.look_at_lh(self.position, self.position + fwd, up)

    def _directional_view(self) -> np.ndarray:
        direction = m3.quat_rotate(self.rotation, np.array([0, -1, 0], dtype=np.float32))
        pos = -direction * self.distance_from_origin
        up = np.array([0, 1, 0], dtype=np.float32)
        L = m3.normalize(-pos)
        if abs(float(np.dot(L, up))) >= 1.0 - 1e-6:
            up = m3.normalize(np.array([0.001, 1, 0], dtype=np.float32))
        return m3.look_at_lh(pos, (0, 0, 0), up)


# D3D cubemap face conventions: +X,-X,+Y,-Y,+Z,-Z
_CUBE_DIRS = np.array(
    [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
    dtype=np.float32)
_CUBE_UPS = np.array(
    [[0, 1, 0], [0, 1, 0], [0, 0, -1], [0, 0, 1], [0, 1, 0], [0, 1, 0]],
    dtype=np.float32)


def cubemap_view_matrix(face: int, position) -> np.ndarray:
    """CubemapUtility::CalculateViewMatrix equivalent (D3D face order)."""
    position = np.asarray(position, dtype=np.float32)
    return m3.look_at_lh(position, position + _CUBE_DIRS[face], _CUBE_UPS[face])


def cubemap_face_of_direction(v: np.ndarray) -> np.ndarray:
    """Dominant-axis cube face index for direction(s) v [..., 3] (D3D order)."""
    av = np.abs(v)
    amax = av.argmax(axis=-1)
    sign_neg = np.take_along_axis(v, amax[..., None], axis=-1)[..., 0] < 0
    return (amax * 2 + sign_neg).astype(np.int32)


# ---------------------------------------------------------------------------
# GPU packing: SoA float arrays consumed by ops/shading.py
#   point:  [position(3), range, color(3), brightness, depth_bias] -> 9 floats
#   spot:   [position(3), outer_cos... ] see PACK layout below
#   dir:    [direction(3), brightness, color(3), depth_bias, shadowing, enabled]
# ---------------------------------------------------------------------------

POINT_STRIDE = 12
SPOT_STRIDE = 12
DIR_STRIDE = 12


def pack_point_lights(lights: list[Light], capacity: int) -> tuple[np.ndarray, int]:
    out = np.zeros((capacity, POINT_STRIDE), dtype=np.float32)
    n = min(len(lights), capacity)
    for i, l in enumerate(lights[:n]):
        out[i, 0:3] = l.position
        out[i, 3] = l.range
        out[i, 4:7] = l.color
        out[i, 7] = l.brightness
        out[i, 8] = l.depth_bias
        out[i, 9] = l.shadow_far
    return out, n


def pack_spot_lights(lights: list[Light], capacity: int) -> tuple[np.ndarray, int]:
    out = np.zeros((capacity, SPOT_STRIDE), dtype=np.float32)
    n = min(len(lights), capacity)
    for i, l in enumerate(lights[:n]):
        out[i, 0:3] = l.position
        out[i, 3] = l.outer_cone_deg * np.pi / 180.0
        out[i, 4:7] = l.color
        out[i, 7] = l.brightness
        out[i, 8:11] = l.direction()
        out[i, 11] = l.depth_bias
        # inner cone + range ride in a second row? keep stride simple:
    # extra params packed separately to keep a single [N,12] tensor:
    return out, n


def pack_spot_extra(lights: list[Light], capacity: int) -> np.ndarray:
    out = np.zeros((capacity, 4), dtype=np.float32)
    for i, l in enumerate(lights[:capacity]):
        out[i, 0] = l.inner_cone_deg * np.pi / 180.0
        out[i, 1] = l.range
    return out


def pack_directional(light: Light | None) -> np.ndarray:
    out = np.zeros((DIR_STRIDE,), dtype=np.float32)
    if light is None:
        return out
    out[0:3] = light.direction()
    out[3] = light.brightness
    out[4:7] = light.color
    out[7] = light.depth_bias
    out[8] = 1.0 if light.casts_shadows else 0.0
    out[9] = 1.0 if light.enabled else 0.0
    return out
