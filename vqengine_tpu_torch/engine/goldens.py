"""The goldens the port renders so far: render a scene with the golden
setup and score it against ``tests/goldens/<name>.png``.

The setup and the bars are those of the reference's golden test
(tests/test_golden.py:151-245): 192x108, the scene's own camera, light
gizmos on, the scene's environment maps built at load at the engine's
default sizes; SSIM >= 0.985, mean MAE < 0.01 and worst 16x16 block MAE
< 0.08 (PNG quantization noise floor ~0.004). The two textured goldens
(textured_quad, gltf_roundtrip) are graph-level scenes of their own
(tests/test_golden.py:17-147), built here on the port's modules.
"""
from __future__ import annotations

import tempfile
from pathlib import Path

import numpy as np
import torch

from ..ops import texture as tex_ops
from ..ops.ibl import procedural_sky_equirect
from ..render import graph
from ..render.renderer import VQRendererTorch
from ..render.scene_buffers import DrawItem, build_scene_buffers
from ..scene import mesh as meshmod
from ..scene.camera import Camera, FCameraParameters
from ..scene.light import ELightType, Light
from ..scene.material import Material
from ..scene.texture_manager import (TextureManager, brick, checkerboard,
                                     generate_mips, noise_texture,
                                     normal_from_height)
from ..utils import math3d as m3
from ..utils.image_io import read_png
from ..utils.ssim import ssim
from .scene_load import load_scene

GOLDEN_DIR = Path(__file__).resolve().parent.parent.parent / "tests" / "goldens"
WIDTH, HEIGHT = 192, 108
# golden -> (scene, render flags), as tests/test_golden.py configures them
SCENES = {"hello_triangle": ("HelloTriangle", {}),
          "hello_cube": ("HelloCube", {}),
          "hello_cube_msaa": ("HelloCube", {"msaa": True}),
          "default_scene": ("Default", {"shadow_dims": (64, 64, 64)}),
          "default_ssao": ("Default", {"shadow_dims": (64, 64, 64),
                                       "enable_ssao": True}),
          "default_ssr": ("Default", {"shadow_dims": (64, 64, 64),
                                      "enable_ssr": True}),
          "default_pcf": ("Default", {"shadow_dims": (128, 64, 128),
                                      "shadow_filter": "pcf"}),
          "envmap_unit_test": ("EnvironmentMapUnitTest", {}),
          "sponza": ("Sponza", {"shadow_dims": (128, 64, 256)}),
          "terrain": ("Terrain", {"shadow_dims": (64, 64, 128)})}
# the graph-level textured goldens: render_golden builds their scenes
TEXTURED = ("textured_quad", "gltf_roundtrip")
# goldens whose PNG predates their scene: tests/goldens/terrain.png shows
# the Terrain of geomorph tiles that the JAX package replaced by quad
# patches (b04d32a), so the reference's own render misses its bars too;
# callers hold the card and the CPU against each other instead
STALE_PNG = ("terrain",)
SSIM_MIN, MEAN_MAE_MAX, BLOCK_MAE_MAX = 0.985, 0.01, 0.08


def _golden_view(buffers, device: torch.device):
    """The textured goldens' environment (a 128x64 sky at small sizes),
    camera and directional light -> (renderer, frame constants, env)."""
    env = graph.build_environment(procedural_sky_equirect(128, 64), device,
                                  diffuse_size=16, specular_base=32,
                                  specular_mips=4, lut_size=64)
    p = FCameraParameters()
    p.position = np.array([0, 2.0, -5.0], np.float32)
    p.pitch_deg = 12.0
    cam = Camera(p, aspect=WIDTH / HEIGHT)
    lights = [Light(type=ELightType.DIRECTIONAL, brightness=1.5,
                    rotation=m3.quat_from_euler_xyz_degrees(50, 0, 20))]
    r = VQRendererTorch(device)
    return r, r.build_frame_constants(buffers, cam, lights), env


def textured_quad_scene():
    """tests/test_golden.py's textured_quad: a checkerboard floor quad
    (bump normal and noise roughness maps, uv scale 4) and a brick sphere
    -> (SceneBuffers, per-level [4, 64, 64, 4] texture levels)."""
    mats = [Material(name="floor"), Material(name="ball")]
    mats[0].textures = {"diffuse": 0, "normal": 2, "roughness": 3}
    mats[0].uv_scale = np.asarray([4.0, 4.0], np.float32)
    mats[1].textures = {"diffuse": 1}
    mats[1].roughness = 0.3
    items = [
        DrawItem("floor", meshmod.quad(8.0),
                 m3.Transform(rotation=m3.quat_from_euler_xyz_degrees(90, 0, 0)),
                 0, 0),
        DrawItem("ball", meshmod.sphere(1.0, 24, 24),
                 m3.Transform(position=np.array([0, 1.0, 0], np.float32)),
                 0, 1),
    ]
    per_tex = [generate_mips(t) for t in
               (checkerboard(64, 8), brick(64), normal_from_height(
                   noise_texture(64, seed=3), 1.5),
                noise_texture(64, base=0.55, amp=0.35))]
    levels = [np.stack([m[lv] for m in per_tex]) for lv in range(len(per_tex[0]))]
    return build_scene_buffers(items, mats), levels


def gltf_roundtrip_scene(device: torch.device):
    """tests/test_golden.py's gltf_roundtrip: a 3-material still life
    exported to a .glb (in a temporary directory of its own) and loaded
    back through scene/gltf.py, brick-textured -> (SceneBuffers,
    PackedTextures on `device`)."""
    from ..scene.gltf import load_gltf_meshes
    from ..scene.gltf_export import export_glb

    def mat(name, dif, rough, metal):
        m = Material(name=name)
        m.diffuse = np.asarray(dif, np.float32)
        m.roughness = rough
        m.metalness = metal
        return m

    mats = [mat("floor", (0.5, 0.45, 0.4), 0.8, 0.0),
            mat("ball", (0.8, 0.3, 0.2), 0.25, 0.0),
            mat("pillar", (0.7, 0.65, 0.3), 0.4, 1.0)]
    objs = [
        ("floor", meshmod.quad(4.0).lods[0],
         m3.Transform(rotation=m3.quat_from_euler_xyz_degrees(90, 0, 0))
         .matrix(), mats[0]),
        ("ball", meshmod.sphere(0.8, 16, 16).lods[0],
         m3.Transform(position=np.array([-0.9, 0.8, 0], np.float32))
         .matrix(), mats[1]),
        ("pillar", meshmod.cylinder(2.0, 0.4, 0.4).lods[0],
         m3.Transform(position=np.array([1.0, 1.0, 0.5], np.float32))
         .matrix(), mats[2]),
    ]
    with tempfile.TemporaryDirectory() as tmp:
        glb = Path(tmp) / "vqe_golden_roundtrip.glb"
        export_glb(objs, glb)
        loaded = load_gltf_meshes(glb)
    tm = TextureManager(size=64)
    b_id = tm.create_from_array("brick", brick(64))
    items, mats_l = [], []
    for i, (mesh, m) in enumerate(loaded):
        m.textures = {"diffuse": b_id}
        mats_l.append(m)
        items.append(DrawItem(mesh.name, mesh, m3.Transform(), i, i))
    textures = tm.build_device_arrays_packed(device)
    return build_scene_buffers(items, mats_l), textures


def atrium_scene(device: torch.device, aspect: float = WIDTH / HEIGHT):
    """A small scene for every textured path: a grazing floor (diffuse,
    normal and roughness maps: combined aux, pair rows; most of its pixels
    anisotropic past the walk's capacity), a ball, a cutout quad whose
    slot-3 alpha-mask map fails the cutout test on its checker's dark
    tiles, and a textured glass quad (alpha 0.5: the transparent part);
    64^2 maps; the opaque part has 1,106 triangles. -> (SceneBuffers,
    PackedTextures on `device`, camera (low, looking along the floor),
    lights)."""
    tm = TextureManager(size=64)
    ids = {"checkerboard": tm.create_from_array("checkerboard", checkerboard(64, 8)),
           "brick": tm.create_from_array("brick", brick(64)),
           "noise": tm.create_from_array("noise", noise_texture(64, seed=3)),
           "normal": tm.create_from_array("normal_from_height", normal_from_height(
               noise_texture(64, seed=21), 1.6))}
    spec = [("floor", meshmod.quad(30.0), (0, 0, 8.0), (90, 0, 0), 1.0,
             {"diffuse": ids["brick"], "normal": ids["normal"],
              "roughness": ids["noise"]}, 6.0),
            ("ball", meshmod.sphere(0.7, 30, 19), (1.2, 0.7, 3.0), (0, 0, 0), 1.0,
             {"diffuse": ids["checkerboard"], "normal": ids["normal"],
              "roughness": ids["noise"]}, 1.0),
            ("cutout", meshmod.quad(1.2), (-0.9, 0.9, 2.0), (0, 0, 0), 1.0,
             {"diffuse": ids["brick"], "alpha_mask": ids["checkerboard"]}, 1.0),
            ("glass", meshmod.quad(0.8), (0.4, 0.6, 1.5), (0, 20, 0), 0.5,
             {"diffuse": ids["checkerboard"]}, 2.0)]
    items, mats = [], []
    for i, (name, mesh, pos, rot, alpha, tex, scale) in enumerate(spec):
        m = Material(name=name)
        m.alpha = alpha
        m.textures = dict(tex)
        m.uv_scale = np.asarray([scale, scale], np.float32)
        mats.append(m)
        items.append(DrawItem(name, mesh, m3.Transform(
            position=np.array(pos, np.float32),
            rotation=m3.quat_from_euler_xyz_degrees(*rot)), i, i))
    tm.combine_aux_maps(mats)
    tm.combine_pair_quads(mats)
    p = FCameraParameters()
    p.position = np.array([0, 0.45, -4.0], np.float32)
    p.pitch_deg = 4.0
    lights = [Light(type=ELightType.DIRECTIONAL, brightness=1.5,
                    rotation=m3.quat_from_euler_xyz_degrees(50, 0, 20))]
    return (build_scene_buffers(items, mats), tm.build_device_arrays_packed(device),
            Camera(p, aspect=aspect), lights)


def _render_textured(golden: str, device: torch.device) -> np.ndarray:
    """textured_quad (quad-packed maps) or gltf_roundtrip, as the
    reference renders them: render_forward with the environment, aniso 2,
    no shadows."""
    if golden == "textured_quad":
        buffers, levels = textured_quad_scene()
        textures = tex_ops.pack_texture_quads(levels, device)
        bucketize = True
    else:
        buffers, textures = gltf_roundtrip_scene(device)
        bucketize = False
    r, consts, env = _golden_view(buffers, device)
    scene = graph.upload_scene(buffers, device, bucketize=bucketize)
    out = graph.render_forward(scene, consts, WIDTH, HEIGHT, env=env,
                               textures=textures,
                               slots_used=graph.slots_used_of(buffers.materials),
                               aniso_taps=2, enable_shadows=False)
    return out["ldr"].cpu().numpy()


def render_golden(golden: str, device: torch.device, env=None) -> np.ndarray:
    """-> ldr [HEIGHT, WIDTH, 3] of the golden's scene, on the host. env:
    the scene's environment maps when the caller has built them
    (graph.build_environment of its equirect at the default sizes), else
    they are built at load."""
    if golden in TEXTURED:
        return _render_textured(golden, device)
    name, flags = SCENES[golden]
    s = load_scene(name, WIDTH, HEIGHT, draw_light_gizmos=True)
    r = VQRendererTorch(device)
    r.load_scene(s.buffers, equirect=s.equirect if env is None else None,
                 textures=s.textures)
    if env is not None:
        r.env = env
    consts = r.build_frame_constants(s.buffers, s.cameras[0], s.lights)
    return r.render(consts, WIDTH, HEIGHT, **flags)["ldr"].cpu().numpy()


def golden_scores(golden: str, img: np.ndarray) -> dict:
    """-> {"ssim", "mean_mae", "block_mae", "ok"} of img against the golden."""
    ref = read_png(GOLDEN_DIR / f"{golden}.png").astype(np.float32)[:, :, :3] / 255.0
    err = np.abs(img - ref).mean(axis=-1)
    h, w = err.shape
    hb, wb = h // 16 * 16, w // 16 * 16
    blocks = err[:hb, :wb].reshape(hb // 16, 16, wb // 16, 16).mean((1, 3))
    scores = {"ssim": float(ssim(img, ref)), "mean_mae": float(err.mean()),
              "block_mae": float(blocks.max())}
    scores["ok"] = (scores["ssim"] >= SSIM_MIN
                    and scores["mean_mae"] < MEAN_MAE_MAX
                    and scores["block_mae"] < BLOCK_MAE_MAX)
    return scores
