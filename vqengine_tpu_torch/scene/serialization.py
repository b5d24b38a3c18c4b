"""Scene/material XML parsing — counterpart of reference
Source/Engine/Core/FileParser.cpp ParseSceneFile / material XML parsing and
Source/Engine/Scene/Serialization.h (FSceneRepresentation,
FGameObjectRepresentation, FMaterialRepresentation).

Schema (see reference Data/Levels/*.xml, Data/Materials/*.xml):
<Scene>
  <EnvironmentMap><Preset>name</Preset> | <Path>..</Path><MaxCLL>N</MaxCLL></EnvironmentMap>
  <Camera><Position/><Pitch/><Yaw/><Projection/><FoV/><Near/><Far/>
          <FirstPerson|Orbit>...</></Camera>
  <GameObject><Transform><Position/><Quaternion|Rotation/><Scale/></Transform>
              <Model><Mesh>builtin | <Path>x.gltf</Path><Name/><MaterialName/></Model>
  </GameObject>
  <Light>... (see reference Default.xml:202-308)</Light>
</Scene>
"""
from __future__ import annotations

import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from ..utils import math3d as m3
from .camera import FCameraParameters
from .light import ELightType, EMobility, Light
from .material import Material


# ---------------------------------------------------------------------------
# representations (reference Serialization.h)
# ---------------------------------------------------------------------------

@dataclass
class FModelRepresentation:
    builtin_mesh_name: str = ""   # <Mesh>Cube</Mesh>
    path: str = ""                # <Path>Data/Models/x.gltf</Path>
    name: str = ""
    material_name: str = ""


@dataclass
class FGameObjectRepresentation:
    transform: m3.Transform = field(default_factory=m3.Transform)
    model: FModelRepresentation = field(default_factory=FModelRepresentation)


@dataclass
class FSceneRepresentation:
    name: str = ""
    env_map_preset: str = ""
    env_map_path: str = ""
    env_map_max_cll: float = 0.0
    cameras: list[FCameraParameters] = field(default_factory=list)
    objects: list[FGameObjectRepresentation] = field(default_factory=list)
    lights: list[Light] = field(default_factory=list)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _floats(text: str) -> list[float]:
    return [float(t) for t in text.replace(",", " ").split()]


def _vec3(el: ET.Element | None, default=(0.0, 0.0, 0.0)) -> np.ndarray:
    if el is None or el.text is None:
        return np.array(default, dtype=np.float32)
    v = _floats(el.text)
    if len(v) == 1:
        v = [v[0]] * 3
    return np.array(v[:3], dtype=np.float32)


def _scalar(el: ET.Element | None, default: float = 0.0) -> float:
    if el is None or el.text is None:
        return default
    vals = _floats(el.text)
    return vals[0] if vals else default


def _text(el: ET.Element | None, default: str = "") -> str:
    return el.text.strip() if el is not None and el.text else default


def _bool(el: ET.Element | None, default: bool = False) -> bool:
    t = _text(el, "").lower()
    if not t:
        return default
    return t in ("1", "true", "yes", "on")


def parse_transform(el: ET.Element | None) -> m3.Transform:
    """Reference FileParser fnParseTransform (FileParser.cpp:517-550):
    <Position>, <Quaternion w last in file as 'x y z w'> or <Rotation>
    (global X,Y,Z degrees), <Scale> (1 or 3 values)."""
    tf = m3.Transform()
    if el is None:
        return tf
    tf.position = _vec3(el.find("Position"))
    scl = el.find("Scale")
    if scl is not None:
        tf.scale = _vec3(scl, default=(1.0, 1.0, 1.0))
    q = el.find("Quaternion")
    if q is not None and q.text:
        x, y, z, w = _floats(q.text)[:4]
        tf.rotation = np.array([w, x, y, z], dtype=np.float32)
    rot = el.find("Rotation")
    if rot is not None and rot.text:
        rx, ry, rz = (_floats(rot.text) + [0.0, 0.0, 0.0])[:3]
        tf.rotation = m3.quat_from_euler_xyz_degrees(rx, ry, rz)
    return tf


# ---------------------------------------------------------------------------
# scene parsing
# ---------------------------------------------------------------------------

def parse_scene_file(path: str | Path) -> FSceneRepresentation:
    path = Path(path)
    rep = FSceneRepresentation(name=path.stem)
    root = ET.parse(str(path)).getroot()

    env = root.find("EnvironmentMap")
    if env is not None:
        rep.env_map_preset = _text(env.find("Preset"))
        # NB: an ElementTree Element with text but no children is falsy,
        # so `find("Path") or find("path")` would drop an uppercase <Path>.
        path_el = env.find("Path")
        if path_el is None:
            path_el = env.find("path")
        rep.env_map_path = _text(path_el)
        rep.env_map_max_cll = _scalar(env.find("MaxCLL"), 0.0)

    for cam_el in root.findall("Camera"):
        p = FCameraParameters()
        p.position = _vec3(cam_el.find("Position"))
        p.pitch_deg = _scalar(cam_el.find("Pitch"))
        p.yaw_deg = _scalar(cam_el.find("Yaw"))
        p.projection = _text(cam_el.find("Projection"), "Perspective")
        p.fov_v_deg = _scalar(cam_el.find("FoV"), 60.0)
        p.near_z = _scalar(cam_el.find("Near"), 0.01)
        p.far_z = _scalar(cam_el.find("Far"), 1000.0)
        fp = cam_el.find("FirstPerson")
        if fp is not None:
            p.translation_speed = _scalar(fp.find("TranslationSpeed"), 1000.0)
            p.angular_speed = _scalar(fp.find("AngularSpeed"), 0.05)
            p.drag = _scalar(fp.find("Drag"), 9.5)
        rep.cameras.append(p)

    for obj_el in root.findall("GameObject"):
        obj = FGameObjectRepresentation()
        obj.transform = parse_transform(obj_el.find("Transform"))
        model_el = obj_el.find("Model")
        if model_el is not None:
            obj.model.builtin_mesh_name = _text(model_el.find("Mesh"))
            obj.model.path = _text(model_el.find("Path"))
            obj.model.name = _text(model_el.find("Name"))
            obj.model.material_name = _text(model_el.find("MaterialName"))
        rep.objects.append(obj)

    for light_el in root.findall("Light"):
        rep.lights.append(_parse_light(light_el))

    return rep


def _parse_light(el: ET.Element) -> Light:
    l = Light()
    if el.find("Point") is not None:
        l.type = ELightType.POINT
    elif el.find("Spot") is not None:
        l.type = ELightType.SPOT
    elif el.find("Directional") is not None:
        l.type = ELightType.DIRECTIONAL
    l.enabled = _bool(el.find("Enabled"), True)
    mob = _text(el.find("Mobility"), "Dynamic").strip().lower()
    l.mobility = {"static": EMobility.STATIC, "stationary": EMobility.STATIONARY,
                  "dynamic": EMobility.DYNAMIC}.get(mob, EMobility.DYNAMIC)
    l.color = _vec3(el.find("Color"), default=(1, 1, 1))
    l.range = _scalar(el.find("Range"), 100.0)
    l.brightness = _scalar(el.find("Brightness"), 1.0)

    tf = parse_transform(el.find("Transform"))
    l.position = tf.position
    l.rotation = tf.rotation
    l.render_scale = float(tf.scale[0])

    sh = el.find("Shadows")
    if sh is not None:
        l.casts_shadows = True
        l.depth_bias = _scalar(sh.find("DepthBias"), 0.001)
        l.shadow_near = _scalar(sh.find("NearPlane"), 0.1)
        l.shadow_far = _scalar(sh.find("FarPlane"), 100.0)

    spot = el.find("Spot")
    if spot is not None:
        l.outer_cone_deg = _scalar(spot.find("OuterConeAngleDegrees"), 25.0)
        l.inner_cone_deg = _scalar(spot.find("InnerConeAngleDegrees"), 20.0)
    pt = el.find("Point")
    if pt is not None:
        l.attenuation = _vec3(pt.find("Attenuation"), default=(1, 1, 1))
    d = el.find("Directional")
    if d is not None:
        l.viewport_x = int(_scalar(d.find("ViewPortX"), 2048))
        l.viewport_y = int(_scalar(d.find("ViewPortY"), 2048))
        l.distance_from_origin = _scalar(d.find("Distance"), 500.0)
    return l


# ---------------------------------------------------------------------------
# material XML parsing (reference Data/Materials/*.xml)
# ---------------------------------------------------------------------------

_TEXTURE_TAGS = {
    "DiffuseMap": "diffuse",
    "NormalMap": "normal",
    "AOMap": "ao",
    "AlphaMaskMap": "alpha_mask",
    "RoughnessMap": "roughness",
    "MetallicMap": "metallic",
    "HeightMap": "height",
    "EmissiveMap": "emissive",
    "OcclusionRoughnessMetalnessMap": "orm",
}


def parse_material_file(path: str | Path) -> list[tuple[Material, dict[str, str]]]:
    """Returns (Material, texture-slot -> file path) pairs; texture IDs are
    resolved later by the asset loader."""
    root = ET.parse(str(path)).getroot()
    out: list[tuple[Material, dict[str, str]]] = []
    for mat_el in root.iter("Material"):
        m = Material(name=_text(mat_el.find("Name"), "Unnamed"))
        if mat_el.find("Diffuse") is not None:
            m.diffuse = _vec3(mat_el.find("Diffuse"), default=(1, 1, 1))
        m.alpha = _scalar(mat_el.find("Alpha"), 1.0)
        if mat_el.find("EmissiveColor") is not None:
            m.emissive_color = _vec3(mat_el.find("EmissiveColor"))
        m.emissive_intensity = _scalar(mat_el.find("EmissiveIntensity"), 0.0)
        m.roughness = _scalar(mat_el.find("Roughness"), 0.8)
        m.metalness = _scalar(mat_el.find("Metalness"), 0.0)
        m.displacement = _scalar(mat_el.find("Displacement"), 0.0)
        tiling = mat_el.find("Tiling")
        if tiling is not None and tiling.text:
            v = _floats(tiling.text)
            m.uv_scale = np.array((v + [1.0])[:2], dtype=np.float32)
        tex_paths: dict[str, str] = {}
        for tag, slot in _TEXTURE_TAGS.items():
            t = _text(mat_el.find(tag))
            if t:
                tex_paths[slot] = t
        out.append((m, tex_paths))
    return out
