"""Cameras — counterpart of reference Source/Engine/Scene/Camera.{h,cpp}:
perspective/orthographic projection, pitch/yaw view state, first-person and
orbit controllers (Camera.h:118-158).

View matrix: XMMatrixLookAtLH equivalent (Camera.cpp:108); projection:
XMMatrixPerspectiveFovLH with vertical FoV (Math.cpp:30-35).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..utils import math3d as m3


@dataclass
class FCameraParameters:
    """Parsed from scene XML <Camera> (FileParser camera block)."""
    position: np.ndarray = field(default_factory=lambda: np.zeros(3, dtype=np.float32))
    pitch_deg: float = 0.0
    yaw_deg: float = 0.0
    projection: str = "Perspective"  # or "Orthographic"
    fov_v_deg: float = 60.0
    near_z: float = 0.01
    far_z: float = 1000.0
    width: float = 1920.0
    height: float = 1080.0
    # first-person controller params
    translation_speed: float = 1000.0
    angular_speed: float = 0.05
    drag: float = 9.5


class Camera:
    def __init__(self, params: FCameraParameters | None = None, aspect: float = 16 / 9):
        p = params or FCameraParameters()
        self.position = np.asarray(p.position, dtype=np.float32).copy()
        self.pitch = float(p.pitch_deg)   # degrees
        self.yaw = float(p.yaw_deg)       # degrees
        self.projection_mode = p.projection
        self.fov_v_deg = float(p.fov_v_deg)
        self.near_z = float(p.near_z)
        self.far_z = float(p.far_z)
        self.aspect = float(aspect)
        self.params = p
        self._velocity = np.zeros(3, dtype=np.float32)

    # ------------------------------------------------------------------
    def rotation_matrix(self) -> np.ndarray:
        """Yaw about +Y then pitch about camera right (reference FPS camera)."""
        ry = m3.quat_to_matrix(m3.quat_from_axis_angle((0, 1, 0), self.yaw * m3.DEG2RAD))
        rx = m3.quat_to_matrix(m3.quat_from_axis_angle((1, 0, 0), self.pitch * m3.DEG2RAD))
        return (ry @ rx).astype(np.float32)

    def forward(self) -> np.ndarray:
        return (self.rotation_matrix()[:3, :3] @ np.array([0, 0, 1], dtype=np.float32))

    def up(self) -> np.ndarray:
        return (self.rotation_matrix()[:3, :3] @ np.array([0, 1, 0], dtype=np.float32))

    def right(self) -> np.ndarray:
        return (self.rotation_matrix()[:3, :3] @ np.array([1, 0, 0], dtype=np.float32))

    def view_matrix(self) -> np.ndarray:
        return m3.look_at_lh(self.position, self.position + self.forward(), self.up())

    def projection_matrix(self) -> np.ndarray:
        if self.projection_mode == "Orthographic":
            return m3.orthographic_lh(self.params.width, self.params.height, self.near_z, self.far_z)
        return m3.perspective_lh(self.fov_v_deg * m3.DEG2RAD, self.aspect, self.near_z, self.far_z)

    def view_projection(self) -> np.ndarray:
        return (self.projection_matrix() @ self.view_matrix()).astype(np.float32)

    # ------------------------------------------------------------------
    # controllers (Camera.h:118-158)
    # ------------------------------------------------------------------
    def update_first_person(self, dt: float, move_local: np.ndarray,
                            d_yaw_deg: float = 0.0, d_pitch_deg: float = 0.0) -> None:
        """First-person: WASD-style local move vector + mouse deltas, with the
        reference's drag-based velocity integration (Drag param)."""
        self.yaw += d_yaw_deg
        self.pitch = float(np.clip(self.pitch + d_pitch_deg, -89.9, 89.9))
        world_move = self.rotation_matrix()[:3, :3] @ np.asarray(move_local, dtype=np.float32)
        accel = world_move * self.params.translation_speed
        drag = self.params.drag
        self._velocity = self._velocity * max(0.0, 1.0 - drag * dt) + accel * dt
        self.position = self.position + self._velocity * dt

    def update_orbit(self, dt: float, look_at: np.ndarray,
                     d_yaw_deg: float = 0.0, d_pitch_deg: float = 0.0) -> None:
        """Orbit controller: rotate the camera about a look-at point keeping
        distance constant (reference OrbitController)."""
        look_at = np.asarray(look_at, dtype=np.float32)
        offset = self.position - look_at
        radius = float(np.linalg.norm(offset))
        self.yaw += d_yaw_deg
        self.pitch = float(np.clip(self.pitch + d_pitch_deg, -89.9, 89.9))
        # position derived from yaw/pitch on the sphere, looking at the target
        back = -(self.rotation_matrix()[:3, :3] @ np.array([0, 0, 1], dtype=np.float32))
        self.position = look_at + back * radius
