"""3D math — counterpart of the reference's DirectXMath helpers
(Source/Engine/Math.cpp, Source/Engine/Scene/Quaternion.{h,cpp},
Source/Engine/Scene/Transform.h, Source/Engine/Culling.h planeset math).

Conventions (chosen to match the reference's D3D output so golden images line
up):
- Left-handed, +Y up, +Z into the screen (XMMatrixLookAtLH / PerspectiveFovLH,
  reference Math.cpp:30-35, Camera.cpp:108).
- Column-vector convention here: ``clip = M @ [x, y, z, 1]^T``.
- NDC depth in [0, 1] (D3D), screen Y inverted relative to NDC Y.

All host math is numpy float32; device math uses the same layouts in jnp.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

DEG2RAD = np.float32(np.pi / 180.0)
RAD2DEG = np.float32(180.0 / np.pi)


def normalize(v: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    n = np.linalg.norm(v, axis=-1, keepdims=True)
    return v / np.maximum(n, eps)


# ---------------------------------------------------------------------------
# Matrices (4x4, column-vector convention; float32)
# ---------------------------------------------------------------------------

def identity4() -> np.ndarray:
    return np.eye(4, dtype=np.float32)


def translation(t) -> np.ndarray:
    m = identity4()
    m[:3, 3] = np.asarray(t, dtype=np.float32)
    return m


def scaling(s) -> np.ndarray:
    s = np.asarray(s, dtype=np.float32)
    if s.ndim == 0:
        s = np.array([s, s, s], dtype=np.float32)
    m = identity4()
    m[0, 0], m[1, 1], m[2, 2] = s
    return m


def perspective_lh(fovy_rad: float, aspect: float, near: float, far: float) -> np.ndarray:
    """XMMatrixPerspectiveFovLH equivalent (reference Math.cpp:30-35).

    fovy is the vertical field of view; depth maps to [0, 1].
    """
    h = 1.0 / np.tan(0.5 * fovy_rad)
    w = h / aspect
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = w
    m[1, 1] = h
    m[2, 2] = far / (far - near)
    m[2, 3] = -near * far / (far - near)
    m[3, 2] = 1.0
    return m


def orthographic_lh(width: float, height: float, near: float, far: float) -> np.ndarray:
    """XMMatrixOrthographicLH equivalent (reference Math.cpp:23-28)."""
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = 2.0 / width
    m[1, 1] = 2.0 / height
    m[2, 2] = 1.0 / (far - near)
    m[2, 3] = -near / (far - near)
    m[3, 3] = 1.0
    return m


def look_at_lh(eye, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """XMMatrixLookAtLH equivalent (reference Camera.cpp:108)."""
    eye = np.asarray(eye, dtype=np.float32)
    target = np.asarray(target, dtype=np.float32)
    up = np.asarray(up, dtype=np.float32)
    f = normalize(target - eye)           # forward (+Z in view space)
    r = normalize(np.cross(up, f))        # right
    u = np.cross(f, r)                    # true up
    m = identity4()
    m[0, :3] = r
    m[1, :3] = u
    m[2, :3] = f
    m[0, 3] = -np.dot(r, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = -np.dot(f, eye)
    return m


def look_to_lh(eye, direction, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    eye = np.asarray(eye, dtype=np.float32)
    direction = np.asarray(direction, dtype=np.float32)
    return look_at_lh(eye, eye + direction, up)


# ---------------------------------------------------------------------------
# Quaternion (w, x, y, z) — reference Quaternion.h stores (w, V=xyz)
# ---------------------------------------------------------------------------

def quat_identity() -> np.ndarray:
    return np.array([1.0, 0.0, 0.0, 0.0], dtype=np.float32)


def quat_from_axis_angle(axis, angle_rad: float) -> np.ndarray:
    axis = normalize(np.asarray(axis, dtype=np.float32))
    half = 0.5 * angle_rad
    s = np.sin(half)
    return np.array([np.cos(half), axis[0] * s, axis[1] * s, axis[2] * s], dtype=np.float32)


def quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Hamilton product: rotation b then a (a ∘ b applied to column vectors)."""
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dtype=np.float32,
    )


def quat_rotate(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    u = np.array([x, y, z], dtype=np.float32)
    v = np.asarray(v, dtype=np.float32)
    return 2.0 * np.dot(u, v) * u + (w * w - np.dot(u, u)) * v + 2.0 * w * np.cross(u, v)


def quat_to_matrix(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / max(np.linalg.norm(q), 1e-12)
    m = identity4()
    m[0, 0] = 1 - 2 * (y * y + z * z)
    m[0, 1] = 2 * (x * y - w * z)
    m[0, 2] = 2 * (x * z + w * y)
    m[1, 0] = 2 * (x * y + w * z)
    m[1, 1] = 1 - 2 * (x * x + z * z)
    m[1, 2] = 2 * (y * z - w * x)
    m[2, 0] = 2 * (x * z - w * y)
    m[2, 1] = 2 * (y * z + w * x)
    m[2, 2] = 1 - 2 * (x * x + y * y)
    return m.astype(np.float32)


def quat_from_euler_xyz_degrees(x_deg: float, y_deg: float, z_deg: float) -> np.ndarray:
    """Sequential global-axis rotations X, then Y, then Z in degrees — matches
    the scene-XML <Rotation> semantics (reference FileParser.cpp:543-549:
    RotateAroundGlobal{X,Y,Z}AxisDegrees applied in that order)."""
    qx = quat_from_axis_angle((1, 0, 0), x_deg * DEG2RAD)
    qy = quat_from_axis_angle((0, 1, 0), y_deg * DEG2RAD)
    qz = quat_from_axis_angle((0, 0, 1), z_deg * DEG2RAD)
    return quat_mul(qz, quat_mul(qy, qx))


# ---------------------------------------------------------------------------
# Transform — SRT compose (reference Transform.h; world = T * R * S)
# ---------------------------------------------------------------------------

@dataclass
class Transform:
    position: np.ndarray = field(default_factory=lambda: np.zeros(3, dtype=np.float32))
    rotation: np.ndarray = field(default_factory=quat_identity)  # (w, x, y, z)
    scale: np.ndarray = field(default_factory=lambda: np.ones(3, dtype=np.float32))

    def matrix(self) -> np.ndarray:
        return translation(self.position) @ quat_to_matrix(self.rotation) @ scaling(self.scale)

    def normal_matrix(self) -> np.ndarray:
        """Inverse-transpose of the world matrix for normal transformation
        (reference Transform::NormalMatrix usage in Batching.cpp CB fill)."""
        w = self.matrix()
        n = np.linalg.inv(w[:3, :3]).T
        out = identity4()
        out[:3, :3] = n
        return out.astype(np.float32)

    def copy(self) -> "Transform":
        return Transform(self.position.copy(), self.rotation.copy(), self.scale.copy())


# ---------------------------------------------------------------------------
# Frustum planes — reference FFrustumPlaneset::ExtractFromMatrix (Culling.h)
# ---------------------------------------------------------------------------

def frustum_planes_from_viewproj(vp: np.ndarray) -> np.ndarray:
    """Extract 6 frustum planes (a,b,c,d with ax+by+cz+d >= 0 inside) from a
    column-convention view-projection matrix. Rows of vp: r0..r3.

    Left/right/bottom/top/near/far for D3D clip space
    (-w<=x<=w, -w<=y<=w, 0<=z<=w).
    """
    r0, r1, r2, r3 = vp[0], vp[1], vp[2], vp[3]
    planes = np.stack(
        [
            r3 + r0,  # left:   x >= -w
            r3 - r0,  # right:  x <=  w
            r3 + r1,  # bottom: y >= -w
            r3 - r1,  # top:    y <=  w
            r2,       # near:   z >=  0
            r3 - r2,  # far:    z <=  w
        ]
    ).astype(np.float32)
    # normalize plane normals so distances are metric
    n = np.linalg.norm(planes[:, :3], axis=1, keepdims=True)
    return planes / np.maximum(n, 1e-12)


def aabb_transform(center: np.ndarray, extents: np.ndarray, m: np.ndarray):
    """Transform a local AABB by matrix m; returns (center, extents) of the
    world-space AABB (used by the BVH build, reference
    SceneBoundingBoxHierarchy.h:28-96)."""
    c = m[:3, :3] @ center + m[:3, 3]
    e = np.abs(m[:3, :3]) @ extents
    return c.astype(np.float32), e.astype(np.float32)
