"""Textured frames of the port against the JAX package on the CPU:
render_forward at 96x54 on each side's own scenes, the reference op by op
(its raster kernels compiled whole, test_torch_slice.compiled_rasters, its
sparse ops too: they round nothing), every texture tap's mip level and row
recorded on both sides (test_torch_texture.Selections). The frames: the
textured_quad golden's scene (quad-packed maps, dense aniso 2), the
gltf_roundtrip golden's still life through each side's .glb export and
load (stochastic trilinear), and goldens.atrium_scene (pair rows with the
combined aux maps and the aniso-8 walk on a grazing floor, its slot-3
alpha mask peeled through K1-bounded and its textured glass layers,
without and with MSAA and the "shade" resolve).

The frames live in a file of their own with two tests: pytest-xdist's
loadfile scheduling hands out files by their number of tests, largest
first, so this file runs beside the lane's longest file
(tests/test_capacity.py, three tests) rather than ahead of it. The rest of
the texture slice's tests are in tests/test_torch_texture.py.

Tolerances: selections, ids and telemetry equal; ldr within 3e-4 (the
reference's multichip bar, tests/test_multichip.py:73)."""
import jax
import numpy as np
import pytest
import torch

from test_torch_msaa import _EXACT
from test_torch_slice import compiled_rasters
from test_torch_texture import (CPU, JAX, PORT, TEX, W, H, Selections,
                                _gltf_objects, bits)
from vqengine_tpu.ops import texture as jt
from vqengine_tpu.render import graph as jg
from vqengine_tpu.render import scene_buffers as jsb
from vqengine_tpu.render.renderer import VQRendererTPU
from vqengine_tpu.scene import material as jmat
from vqengine_tpu.scene import mesh as jmesh
from vqengine_tpu.scene import texture_manager as jtm
from vqengine_tpu.utils import math3d as jm3
from vqengine_tpu_torch.engine import goldens
from vqengine_tpu_torch.ops import texture as tt
from vqengine_tpu_torch.render import graph as tg
from vqengine_tpu_torch.render.renderer import frame_constants_numpy

torch.set_num_threads(1)

LDR_TOL = 3e-4


@pytest.fixture(scope="module", autouse=True)
def compiled_exact_ops():
    """The reference's ops/sparse.py compiled whole (they count, move and
    compare, and round nothing; tests/test_torch_msaa.py)."""
    orig = [(mod, name, getattr(mod, name)) for mod, name, _ in _EXACT]
    for mod, name, static in _EXACT:
        setattr(mod, name, jax.jit(getattr(mod, name), static_argnames=static))
    yield
    for mod, name, fn in orig:
        setattr(mod, name, fn)


def _view(pkg, position=(0, 2.0, -5.0), pitch=12.0):
    p = pkg.cam.FCameraParameters()
    p.position = np.array(position, np.float32)
    p.pitch_deg = pitch
    cam = pkg.cam.Camera(p, aspect=W / H)
    lights = [pkg.light.Light(type=pkg.light.ELightType.DIRECTIONAL, brightness=1.5,
                              rotation=pkg.m3.quat_from_euler_xyz_degrees(50, 0, 20))]
    return cam, lights


def _textured_quad(pkg, tmp):
    """The textured_quad golden's scene: quad-packed maps (diffuse,
    normal and roughness slots), no pairs."""
    if pkg is PORT:
        buffers, levels = goldens.textured_quad_scene()
        return buffers, tt.pack_texture_quads(levels, CPU)
    mats = [jmat.Material(name="floor"), jmat.Material(name="ball")]
    mats[0].textures = {"diffuse": 0, "normal": 2, "roughness": 3}
    mats[0].uv_scale = np.asarray([4.0, 4.0], np.float32)
    mats[1].textures = {"diffuse": 1}
    mats[1].roughness = 0.3
    items = [jsb.DrawItem("floor", jmesh.quad(8.0), jm3.Transform(
                 rotation=jm3.quat_from_euler_xyz_degrees(90, 0, 0)), 0, 0),
             jsb.DrawItem("ball", jmesh.sphere(1.0, 24, 24), jm3.Transform(
                 position=np.array([0, 1.0, 0], np.float32)), 0, 1)]
    per = [jtm.generate_mips(x) for x in (
        jtm.checkerboard(64, 8), jtm.brick(64),
        jtm.normal_from_height(jtm.noise_texture(64, seed=3), 1.5),
        jtm.noise_texture(64, base=0.55, amp=0.35))]
    levels = [np.stack([m[lv] for m in per]) for lv in range(len(per[0]))]
    return jsb.build_scene_buffers(items, mats), jt.pack_texture_quads(levels)


def _gltf(pkg, tmp):
    """The gltf_roundtrip golden's still life through each side's .glb
    export and load, brick-textured (quads, no pairs)."""
    path = tmp / f"{'port' if pkg is PORT else 'jax'}.glb"
    pkg.gexp.export_glb(_gltf_objects(pkg), path)
    tm = pkg.tm.TextureManager(size=TEX)
    b_id = tm.create_from_array("brick", pkg.tm.brick(TEX))
    items, mats = [], []
    for i, (mesh, m) in enumerate(pkg.gltf.load_gltf_meshes(path)):
        m.textures = {"diffuse": b_id}
        mats.append(m)
        items.append(pkg.sb.DrawItem(mesh.name, mesh, pkg.m3.Transform(), i, i))
    tex = (tm.build_device_arrays_packed(CPU) if pkg is PORT
           else tm.build_device_arrays_packed())
    return pkg.sb.build_scene_buffers(items, mats), tex


def _atrium(pkg, tmp):
    """goldens.atrium_scene on each side (the port's own; the reference's
    built here from the same spec on the JAX package's modules)."""
    if pkg is PORT:
        buffers, tex, _, _ = goldens.atrium_scene(CPU, aspect=W / H)
        return buffers, tex
    tm = jtm.TextureManager(size=TEX)
    ids = {"checkerboard": tm.create_from_array("checkerboard", jtm.checkerboard(64, 8)),
           "brick": tm.create_from_array("brick", jtm.brick(64)),
           "noise": tm.create_from_array("noise", jtm.noise_texture(64, seed=3)),
           "normal": tm.create_from_array("normal_from_height", jtm.normal_from_height(
               jtm.noise_texture(64, seed=21), 1.6))}
    spec = [("floor", jmesh.quad(30.0), (0, 0, 8.0), (90, 0, 0), 1.0,
             {"diffuse": ids["brick"], "normal": ids["normal"],
              "roughness": ids["noise"]}, 6.0),
            ("ball", jmesh.sphere(0.7, 30, 19), (1.2, 0.7, 3.0), (0, 0, 0), 1.0,
             {"diffuse": ids["checkerboard"], "normal": ids["normal"],
              "roughness": ids["noise"]}, 1.0),
            ("cutout", jmesh.quad(1.2), (-0.9, 0.9, 2.0), (0, 0, 0), 1.0,
             {"diffuse": ids["brick"], "alpha_mask": ids["checkerboard"]}, 1.0),
            ("glass", jmesh.quad(0.8), (0.4, 0.6, 1.5), (0, 20, 0), 0.5,
             {"diffuse": ids["checkerboard"]}, 2.0)]
    items, mats = [], []
    for i, (name, mesh, pos, rot, alpha, tex, scale) in enumerate(spec):
        m = jmat.Material(name=name)
        m.alpha = alpha
        m.textures = dict(tex)
        m.uv_scale = np.asarray([scale, scale], np.float32)
        mats.append(m)
        items.append(jsb.DrawItem(name, mesh, jm3.Transform(
            position=np.array(pos, np.float32),
            rotation=jm3.quat_from_euler_xyz_degrees(*rot)), i, i))
    tm.combine_aux_maps(mats)
    assert tm.combine_pair_quads(mats) == 4
    return jsb.build_scene_buffers(items, mats), tm.build_device_arrays_packed()


SCENES = {"textured_quad": (_textured_quad, {}),
          "gltf": (_gltf, {}),
          "atrium": (_atrium, {"position": (0, 0.45, -4.0), "pitch": 4.0})}

# frame -> (scene, render flags); the atrium's frames cover the pair rows
# with the combined aux maps and the aniso-8 walk, the textured alpha peel
# (K1-bounded) with and without MSAA, the textured transparent layers and
# the "shade" resolve
FRAMES = {
    "textured_quad": ("textured_quad", dict(aniso_taps=2)),
    "gltf_stochastic": ("gltf", dict(aniso_taps=0)),
    "atrium_peel_transparent": ("atrium", dict(aniso_taps=8, enable_alpha_mask=True)),
    "atrium_msaa_shade": ("atrium", dict(aniso_taps=8, enable_alpha_mask=True,
                                         msaa=True, msaa_edge_resolve="shade")),
}


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """Each scene on both sides: (opaque, transparent, consts, textures,
    slots_used, buffers)."""
    tmp = tmp_path_factory.mktemp("glb")
    out = {}
    for name, (build, view) in SCENES.items():
        sides = {}
        for tag, pkg in (("port", PORT), ("jax", JAX)):
            buffers, tex = build(pkg, tmp)
            cam, lights = _view(pkg, **view)
            opaque, transp = pkg.sb.split_transparent(buffers)
            if pkg is PORT:
                sides[tag] = (tg.upload_scene(opaque, CPU),
                              None if transp is None else tg.upload_scene(transp, CPU),
                              tg.frame_constants_from_numpy(
                                  frame_constants_numpy(buffers, cam, lights), CPU),
                              tex, tg.slots_used_of(buffers.materials), buffers)
            else:
                sides[tag] = (jg.upload_scene(opaque),
                              None if transp is None else jg.upload_scene(transp),
                              VQRendererTPU().build_frame_constants(buffers, cam, lights),
                              tex, jg.slots_used_of(buffers.materials), buffers)
        out[name] = sides
    return out


@pytest.fixture(scope="module")
def frames(scenes):
    """Every frame of FRAMES on both sides (no shadows, no environment),
    with its selections recorded."""
    out = {}
    for frame, (scene, flags) in FRAMES.items():
        res = {}
        with Selections() as sel:
            for tag, mod in (("port", tg), ("jax", jg)):
                opaque, transp, consts, tex, slots, _ = scenes[scene][tag]
                with compiled_rasters():
                    res[tag] = mod.render_forward(
                        opaque, consts, W, H, enable_shadows=False, textures=tex,
                        slots_used=slots,
                        scene_transparent=transp, **flags)
        out[frame] = (res, sel.mismatches())
    return out


def test_textured_frames_match_jax(frames):
    """render_forward with textures at 96x54 against the op-by-op
    reference, each frame of FRAMES: tri_id, object_id and the overflow
    equal, ldr within 3e-4, the telemetry equal, and every tap's mip level
    and row equal; in the atrium the grazing floor wants more than the
    walk's capacity and the ladder's rung above 1.3 fills it without
    overflowing."""
    bad = {}
    for frame, (res, sel) in frames.items():
        port, ref = res["port"], res["jax"]
        problems = []
        if not (sel["taps"] > 0 and sel["levels"] == 0 and sel["rows"] == 0):
            problems.append(("selections", sel))
        for key in ("tri_id", "object_id", "overflow"):
            if not np.array_equal(bits(port[key]), bits(ref[key])):
                problems.append(key)
        diff = float(np.abs(port["ldr"].numpy() - np.asarray(ref["ldr"])).max())
        if not diff <= LDR_TOL:
            problems.append(("ldr", diff))
        if not bool(torch.isfinite(port["hdr"]).all()):
            problems.append("hdr not finite")
        if sorted(port["saturation"]) != sorted(ref["saturation"]) or any(
                not np.array_equal(bits(port["saturation"][k]), bits(v))
                for k, v in ref["saturation"].items()):
            problems.append(("saturation", port["saturation"], ref["saturation"]))
        if frame.startswith("atrium"):
            sat = {k: float(v) for k, v in port["saturation"].items()}
            if not (sat["tex_aniso_demand"] > 1.0 and 0.0 < sat["tex_aniso"] <= 1.0):
                problems.append(("rung", sat))
        if problems:
            bad[frame] = problems
    assert not bad, bad


def test_alpha_peel_and_layers_take_effect(scenes, frames):
    """The atrium's cutout fails on its checker's dark tiles: without the
    peel those pixels keep the cutout, with it they show what lies behind;
    and the textured glass layer changes the frame."""
    opaque, transp, consts, tex, slots, _ = scenes["atrium"]["port"]
    peel = frames["atrium_peel_transparent"][0]["port"]

    def frame(**kw):
        return tg.render_forward(opaque, consts, W, H, enable_shadows=False,
                                 textures=tex, slots_used=slots, aniso_taps=8, **kw)
    no_peel = frame(scene_transparent=transp)
    no_glass = frame(enable_alpha_mask=True)
    assert int((peel["tri_id"] != no_peel["tri_id"]).sum()) > 20
    assert torch.equal(peel["tri_id"], no_glass["tri_id"])
    assert int(((peel["ldr"] - no_glass["ldr"]).abs().amax(-1) > 1e-3).sum()) > 20
