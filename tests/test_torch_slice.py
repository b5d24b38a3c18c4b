"""Parity of the port's forward main path (render_forward with default
flags) with the JAX package: the port's own copies of the host modules
(scene load, upload, frame constants), the entry() frame, the hello
goldens, shadowed frames, and a run of the port that imports neither jax
nor the JAX package.

Each side loads its scenes with its own host modules: the port's Light
objects carry the port's ELightType, so handing them to the JAX package
(or the reverse) would drop every light."""
import contextlib
import dataclasses
import functools
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import jax
from vqengine_tpu.ops import raster as jr
from vqengine_tpu.render import graph as jg
from vqengine_tpu.render.renderer import VQRendererTPU
from vqengine_tpu.render.scene_buffers import assemble_scene
from vqengine_tpu.scene.material import Material
from vqengine_tpu.scene.mesh import build_builtin_meshes
from vqengine_tpu.scene.scenes import augment_scene
from vqengine_tpu.scene.serialization import (parse_material_file,
                                              parse_scene_file)
from vqengine_tpu_torch.engine.goldens import golden_scores, render_golden
from vqengine_tpu_torch.engine.scene_load import find_data_dirs, load_scene
from vqengine_tpu_torch.entry import WIDTH, HEIGHT, entry, tiny_scene_numpy
from vqengine_tpu_torch.ops.ibl import procedural_sky_equirect
from vqengine_tpu_torch.render import graph as tg
from vqengine_tpu_torch.render.renderer import (VQRendererTorch,
                                                frame_constants_numpy)

torch.set_num_threads(1)

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parent.parent
GOLDEN_W, GOLDEN_H = 192, 108


def leaves(dc) -> dict:
    return {f.name: None if getattr(dc, f.name) is None
            else np.asarray(getattr(dc, f.name))
            for f in dataclasses.fields(dc)}


def bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


_REF_K1, _REF_K2 = jr.rasterize_gbuf, jr.rasterize


@functools.cache
def _compiled(kernel, width: int, height: int, msaa: bool):
    return jax.jit(functools.partial(kernel, width=width, height=height,
                                     msaa=msaa))


@functools.cache
def _compiled_bounded(width: int, height: int, msaa: bool):
    return jax.jit(lambda binned, zbound: _REF_K1(
        binned, width=width, height=height, msaa=msaa, zbound=zbound))


def _k1(binned, width, height, msaa=False, zbound=None):
    if zbound is None:
        return _compiled(_REF_K1, width, height, msaa)(binned)
    return _compiled_bounded(width, height, msaa)(binned, tuple(zbound))


def _k2(binned, width, height, msaa=False):
    return _compiled(_REF_K2, width, height, msaa)(binned)


@contextlib.contextmanager
def compiled_rasters():
    """The reference's raster kernels (raster.rasterize_gbuf, K1, bounded
    or not, and raster.rasterize, K2) compiled whole under jax.jit while the context
    lasts, wherever the JAX package calls them. An interpret-mode kernel
    body is compiled in either case, so the outputs are the op-by-op
    call's bit for bit (checked on the crossing quads, HelloCube, the
    entry frame, Sponza's frame and caster views, and crafted records),
    and a call takes a fraction of its op-by-op time; the code around the
    kernels still runs op by op (jit would contract its multiply-adds)."""
    jr.rasterize_gbuf, jr.rasterize = _k1, _k2
    try:
        yield
    finally:
        jr.rasterize_gbuf, jr.rasterize = _REF_K1, _REF_K2


def jax_load_scene(name: str, width: int, height: int):
    """The JAX package's own host load of Data/Levels/<name>.xml (the steps
    of the port's load_scene and of the engine's _load_scene_host, on the
    JAX package's modules) -> (SceneBuffers, cameras, lights)."""
    data_dirs = find_data_dirs()
    lib = {}
    for d in reversed(data_dirs):
        if (d / "Materials").is_dir():
            for xml in sorted((d / "Materials").glob("*.xml")):
                for mat, _ in parse_material_file(xml):
                    lib[mat.name] = mat
    for tid, mname in enumerate(("Checkerboard", "Checkerboard_Grayscale")):
        m = Material(name=mname)
        m.textures["diffuse"] = tid
        lib[mname] = m
    path = next(d / "Levels" / f"{name}.xml" for d in data_dirs
                if (d / "Levels" / f"{name}.xml").is_file())
    rep = parse_scene_file(path)
    meshes = build_builtin_meshes()
    augment_scene(rep.name, rep, lib, meshes, data_dirs=data_dirs)
    buffers, cameras, lights = assemble_scene(rep, meshes, lib,
                                              draw_light_gizmos=True)
    for c in cameras:
        c.aspect = width / max(1, height)
    return buffers, cameras, lights


def scene_inputs(name):
    """-> (port (SceneBuffers, camera, lights), JAX (SceneBuffers, camera,
    lights) or None, bucketize), each side loaded by its own modules, as
    each caller of the reference uploads them: entry() unbucketed, the
    engine bucketed. The JAX side of entry() is __graft_entry__'s."""
    if name == "entry":
        return tiny_scene_numpy(), None, False
    s = load_scene(name, GOLDEN_W, GOLDEN_H)
    b, cams, lights = jax_load_scene(name, GOLDEN_W, GOLDEN_H)
    return (s.buffers, s.cameras[0], s.lights), (b, cams[0], lights), True


SCENES = ["entry", "HelloCube", "Default", "Sponza"]


@pytest.mark.parametrize("name", SCENES)
def test_upload_scene_matches(name):
    """The port's host modules (scene load + assembly) and upload give
    arrays bitwise equal to the JAX package's own."""
    (buffers, _, _), jax_side, bucketize = scene_inputs(name)
    ref = (graft._tiny_scene_and_consts(WIDTH, HEIGHT)[0] if jax_side is None
           else jg.upload_scene(jax_side[0], bucketize=bucketize))
    out = tg.upload_scene(buffers, CPU, bucketize=bucketize)
    assert out.num_tris_live == ref.num_tris_live
    for f in dataclasses.fields(out):
        a, b = getattr(out, f.name), getattr(ref, f.name)
        assert (a is None) == (b is None), f.name
        if isinstance(a, torch.Tensor):
            np.testing.assert_array_equal(bits(a.numpy()), bits(b), f.name)
        elif a is not None:
            assert a == b, f.name               # the static numbers


@pytest.mark.parametrize("name", SCENES)
def test_frame_constants_match(name):
    """Lights, casters and matrices: the port's frame_constants_numpy on its
    own scene against the JAX package's build_frame_constants on its own."""
    (buffers, cam, lights), jax_side, _ = scene_inputs(name)
    ref = (graft._tiny_scene_and_consts(WIDTH, HEIGHT)[1] if jax_side is None
           else VQRendererTPU().build_frame_constants(*jax_side))
    out = tg.frame_constants_from_numpy(
        frame_constants_numpy(buffers, cam, lights), CPU)
    if name in ("Default", "Sponza"):
        assert out.spot_casters.shape[0] == 1 and out.dir_vp.shape[0] == 1
    for f in dataclasses.fields(ref):
        a = getattr(out, f.name).numpy()
        b = np.asarray(getattr(ref, f.name))
        assert a.shape == b.shape and a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(bits(a), bits(b), f.name)


def test_entry_ldr_matches_jax():
    """entry() at 256x128: tri_id agrees on >= 99.9% of pixels (all,
    measured) and ldr within 3e-4 where it agrees, the multichip bar of
    the reference (tests/test_multichip.py:73). The reference runs op by
    op, as that test runs it (measured: max 3e-7), its raster kernel
    compiled whole (compiled_rasters)."""
    scene, consts = graft._tiny_scene_and_consts(WIDTH, HEIGHT)
    with compiled_rasters():
        ref = jg.render_forward(scene, consts, WIDTH, HEIGHT)
    fn, (ts, tc) = entry(CPU)
    ldr = fn(ts, tc).numpy()
    out = tg.render_forward(ts, tc, WIDTH, HEIGHT)
    assert np.array_equal(out["ldr"].numpy(), ldr)
    assert ldr.shape == (HEIGHT, WIDTH, 3) and np.isfinite(ldr).all()
    same = out["tri_id"].numpy() == np.asarray(ref["tri_id"])
    assert same.mean() >= 0.999
    np.testing.assert_allclose(ldr[same], np.asarray(ref["ldr"])[same],
                               rtol=0, atol=3e-4)
    for key in ("overflow", "pair_demand", "object_id"):
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]))


# the post chain's tail: the entry scene rendered at half its size and
# upscaled by FSR1 to WIDTH x HEIGHT, without and with CAS before the upscale
POST_CASES = {"fsr1": {}, "cas+fsr1": {"cas_sharpness": 0.5}}


@pytest.fixture(scope="module")
def post_tail_reference():
    """The reference's frames of POST_CASES, op by op, rendered at 128x64
    with the entry() frame's consts (the same 2:1 aspect). In this module
    the reference's per-triangle ops are compiled already (or will be, for
    test_entry_ldr_matches_jax), so the two frames cost the per-pixel
    ones and the tail."""
    scene, consts = graft._tiny_scene_and_consts(WIDTH, HEIGHT)
    with compiled_rasters():
        return {name: jg.render_forward(scene, consts, WIDTH // 2, HEIGHT // 2,
                                        out_width=WIDTH, out_height=HEIGHT,
                                        **kw)
                for name, kw in POST_CASES.items()}


@pytest.mark.parametrize("case", list(POST_CASES))
def test_post_tail_frame_matches_jax(post_tail_reference, entry_cpu, case):
    """render_forward's FSR1 upscale (128x64 -> 256x128), without and with
    CAS (cas_sharpness 0.5), against the reference's render_forward at the
    same arguments: tri_id equal at the render size, ldr (and the pre-tail
    hdr) within 3e-4, the frames' bar (tests/test_multichip.py:73)."""
    ref = post_tail_reference[case]
    scene, consts = entry_cpu
    out = tg.render_forward(scene, consts, WIDTH // 2, HEIGHT // 2,
                            out_width=WIDTH, out_height=HEIGHT,
                            **POST_CASES[case])
    ldr = out["ldr"].numpy()
    assert ldr.shape == (HEIGHT, WIDTH, 3) and np.isfinite(ldr).all()
    assert tuple(out["hdr"].shape) == (HEIGHT // 2, WIDTH // 2, 3)
    np.testing.assert_array_equal(out["tri_id"].numpy(), np.asarray(ref["tri_id"]))
    np.testing.assert_allclose(ldr, np.asarray(ref["ldr"]), rtol=0, atol=3e-4)
    np.testing.assert_allclose(out["hdr"].numpy(), np.asarray(ref["hdr"]),
                               rtol=0, atol=3e-4)


@pytest.mark.parametrize("name,golden", [("HelloTriangle", "hello_triangle"),
                                         ("HelloCube", "hello_cube"),
                                         ("HelloCube", "hello_cube_msaa")])
def test_golden(name, golden):
    """The golden bars of tests/test_golden.py:224-245, with the golden
    setup: the scene's own camera and light gizmos on (and MSAA with the
    default edge resolve for hello_cube_msaa)."""
    scores = golden_scores(golden, render_golden(golden, CPU))
    assert scores["ok"], scores


_NO_JAX = """
import sys, torch
torch.set_num_threads(1)
from vqengine_tpu_torch.engine.scene_load import load_scene
from vqengine_tpu_torch.render.renderer import VQRendererTorch
s = load_scene("Sponza", 64, 64, material_alpha={"SponzaBrass": 0.5})
r = VQRendererTorch(torch.device("cpu"))
r.load_scene(s.buffers)
assert r.scene_t is not None and r.scene_t.num_tris_live > 0
consts = r.build_frame_constants(s.buffers, s.cameras[0], s.lights)
assert consts.point_casters.shape[0] == 1 and consts.dir_vp.shape[0] == 1
out = r.render(consts, 64, 64, shadow_dims=(32, 32, 32), msaa=True)
assert tuple(out["ldr"].shape) == (64, 64, 3)
assert "msaa_edges" in out["saturation"]
assert bool(torch.isfinite(out["ldr"]).all())
assert float((out["tri_id"] >= 0).float().mean()) > 0.05
from vqengine_tpu_torch.engine.goldens import atrium_scene
buffers, tex, cam, lights = atrium_scene(torch.device("cpu"), aspect=1.0)
r.load_scene(buffers, textures=tex)
assert r._any_alpha_mask and r.scene_t is not None
consts = r.build_frame_constants(buffers, cam, lights)
out = r.render(consts, 64, 64, enable_shadows=False, msaa=True, aniso_taps=8)
assert "tex_aniso" in out["saturation"]
assert bool(torch.isfinite(out["ldr"]).all())
bad = [m for m in sys.modules
       if m in ("jax", "vqengine_tpu") or m.startswith(("jax.", "vqengine_tpu."))]
assert not bad, f"the port imported {bad}"
print("ok")
"""


def test_port_renders_without_jax():
    """A shadowed Sponza frame (all three caster kinds, maps rendered in
    the frame) with MSAA, the edge resolve and a translucent material (the
    transparent pass), then a textured frame (goldens.atrium_scene: pair
    rows, the aniso-8 walk, the alpha peel, a textured glass layer, MSAA),
    in a fresh process: neither jax nor any module of the JAX package gets
    imported."""
    res = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().endswith("ok")


@pytest.fixture(scope="module")
def entry_cpu():
    return entry(CPU)[1]


@pytest.mark.parametrize("kw", [
    dict(env=object()), dict(textures="checkerboard"), dict(enable_ssao=True),
    dict(enable_ssr=True), dict(enable_motion_vectors=True),
    dict(enable_alpha_mask=True), dict(scene_transparent="scene"),
    dict(cas_sharpness=0.5),
    dict(out_width=2 * WIDTH, out_height=2 * HEIGHT)])
def test_unported_features_raise(entry_cpu, kw):
    """Features of later slices raised. Every case is ported since and
    holds the reference's behaviour instead: cas_sharpness sharpens ldr
    and out_width/out_height upscale it with FSR1 to the new size, the
    frame before the tail (hdr, depth, tri_id, object_id) unchanged
    (test_post_tail_frame_matches_jax and tests/test_torch_post.py hold
    them against the reference); textures (a 16^2 checkerboard, the
    entry scene's materials pointing their diffuse slot at it) change the
    frame, and with aniso_taps 8 the adaptive walk reports tex_aniso
    (tests/test_torch_texture.py holds them against the reference);
    enable_alpha_mask without textures
    renders the frame without it (the reference's alpha_test needs
    textures); the entry scene as its own transparent part renders the
    opaque frame unchanged (every transparent fragment lies exactly on
    the opaque depth, and the peel's window is open: coplanar transparent
    fragments drop, as in the reference); an environment (a small
    procedural sky's maps) lights the frame and puts the skydome behind
    it (tests/test_torch_ibl.py holds it against the reference);
    enable_ssao darkens the ambient term and returns out["ao"],
    enable_ssr returns out["ssr_history"] and changes the frame once the
    entry scene's material is glossy (its roughness of 0.8 gives the
    composite no weight), and
    enable_motion_vectors returns out["motion"] and leaves the frame as it
    is (tests/test_torch_ssao.py and tests/test_torch_ssr.py hold them
    against the reference)."""
    scene, consts = entry_cpu
    post = {"enable_ssao": "ao", "enable_ssr": "ssr_history",
            "enable_motion_vectors": "motion"}
    if set(kw) & set(post):
        key = post[next(iter(kw))]
        if key == "ssr_history":
            mats = scene.materials.clone()
            mats[:, 12] = 0.1
            scene = dataclasses.replace(scene, materials=mats)
        base = tg.render_forward(scene, consts, WIDTH, HEIGHT)
        out = tg.render_forward(scene, consts, WIDTH, HEIGHT, **kw)
        assert key in out and key not in base
        assert bool(torch.isfinite(out[key]).all())
        assert torch.equal(out["tri_id"], base["tri_id"])
        changed = not torch.equal(out["ldr"], base["ldr"])
        assert changed == (key != "motion"), key
        return
    if "textures" in kw:
        from vqengine_tpu_torch.ops import texture
        from vqengine_tpu_torch.scene.texture_manager import (checkerboard,
                                                              generate_mips)
        mats = scene.materials.clone()
        mats[:, 20] = 0.0            # the diffuse slot samples texture 0
        scene = dataclasses.replace(scene, materials=mats)
        tex = texture.pack_texture_quads(
            [m[None] for m in generate_mips(checkerboard(16, 4))], CPU)
        base = tg.render_forward(scene, consts, WIDTH, HEIGHT)
        out = tg.render_forward(scene, consts, WIDTH, HEIGHT, textures=tex,
                                aniso_taps=8)
        assert "tex_aniso" in out["saturation"]
        assert "tex_aniso" not in base["saturation"]
        assert 0.0 <= float(out["saturation"]["tex_aniso"]) <= 1.0
        assert torch.equal(out["tri_id"], base["tri_id"])
        assert bool(torch.isfinite(out["ldr"]).all())
        assert not torch.equal(out["ldr"], base["ldr"])
        return
    if "env" in kw:
        env = tg.build_environment(procedural_sky_equirect(32, 16), CPU,
                                   diffuse_size=4, specular_base=8,
                                   lut_size=16)
        base = tg.render_forward(scene, consts, WIDTH, HEIGHT)
        out = tg.render_forward(scene, consts, WIDTH, HEIGHT, env=env)
        bg = out["tri_id"] < 0
        assert bool(torch.isfinite(out["ldr"]).all()) and bool(bg.any())
        assert torch.equal(out["tri_id"], base["tri_id"])
        assert not torch.equal(out["ldr"][~bg], base["ldr"][~bg])
        assert not torch.equal(out["ldr"][bg], base["ldr"][bg])
        return
    if "enable_alpha_mask" in kw or "scene_transparent" in kw:
        if "scene_transparent" in kw:
            kw = dict(scene_transparent=scene)
        base = tg.render_forward(scene, consts, WIDTH, HEIGHT)
        out = tg.render_forward(scene, consts, WIDTH, HEIGHT, **kw)
        for key in ("ldr", "hdr", "depth", "tri_id", "object_id"):
            assert torch.equal(out[key], base[key]), key
        return
    # the post chain's tail: CAS sharpens ldr; FSR1 upscales it to
    # out_width x out_height; the frame before the tail stays as it was
    base = tg.render_forward(scene, consts, WIDTH, HEIGHT)
    out = tg.render_forward(scene, consts, WIDTH, HEIGHT, **kw)
    for key in ("hdr", "depth", "tri_id", "object_id"):
        assert torch.equal(out[key], base[key]), key
    assert bool(torch.isfinite(out["ldr"]).all())
    if "out_width" in kw:
        assert tuple(out["ldr"].shape) == (kw["out_height"], kw["out_width"], 3)
    else:
        assert out["ldr"].shape == base["ldr"].shape
        assert not torch.equal(out["ldr"], base["ldr"])


@pytest.mark.parametrize("name", ["Default", "Sponza"])
def test_shadowed_frame_renders(name):
    """The default flags (shadows on, ESM) and PCF render both scenes;
    maps from precompute_shadow_maps give the same frame as maps
    rendered in the frame; shadows change the image, and with
    enable_shadows=False the caster lights drop out, as in the
    reference."""
    w, h, dims = 128, 64, (16, 16, 16)
    s = load_scene(name, w, h)
    r = VQRendererTorch(CPU)
    r.load_scene(s.buffers)
    consts = r.build_frame_constants(s.buffers, s.cameras[0], s.lights)
    frames = {}
    for flt in ("esm", "pcf"):
        out = r.render(consts, w, h, shadow_dims=dims, shadow_filter=flt)
        maps = r.precompute_shadow_maps(consts, dims, flt)
        cached = r.render(consts, w, h, shadow_dims=dims, shadow_filter=flt,
                          shadow_maps=maps)
        assert torch.equal(out["ldr"], cached["ldr"]), flt
        assert bool(torch.isfinite(out["ldr"]).all())
        assert int(out["overflow"].sum()) == 0
        frames[flt] = out["ldr"]
    off = r.render(consts, w, h, enable_shadows=False)["ldr"]
    assert not torch.equal(frames["esm"], off)
    assert not torch.equal(frames["pcf"], frames["esm"])


def test_tessellation_raises(entry_cpu):
    """Tessellation is ported (tests/test_torch_tessellation.py), so
    nothing raises any more: a geomorph table equal to the positions (a
    morph that moves nothing) renders the frame bit for bit, and a patch
    table uploads into the DeviceScene."""
    scene, consts = entry_cpu
    morphing = dataclasses.replace(scene, corner_morph_mid=scene.corner_positions)
    ref = tg.render_forward(scene, consts, WIDTH, HEIGHT)
    out = tg.render_forward(morphing, consts, WIDTH, HEIGHT)
    np.testing.assert_array_equal(bits(out["ldr"].numpy()), bits(ref["ldr"].numpy()))
    fields = leaves(scene)
    fields["patch_corners"] = np.zeros((1, 4, 3), np.float32)
    up = tg.device_scene_from_numpy(fields, scene.num_tris_live, CPU)
    assert tuple(up.patch_corners.shape) == (1, 4, 3)


def test_shade_forward_matches_jax():
    """Direct lights including shadowed casters and the directional shadow
    factor (paths the main path does not reach yet) on random pixels:
    the same BRDF in the same order, but the two libraries' sqrt, arccos
    and division differ in the last ulp, and arccos near |cos| = 1 and
    1/d^2 near a light amplify that (measured: 2 of 12288 values beyond
    1e-5 relative, at most 1.2e-4); hence rtol 5e-4."""
    import jax.numpy as jnp
    from vqengine_tpu.ops import shading as js_
    from vqengine_tpu_torch.ops import shading as ts_
    rng = np.random.default_rng(7)
    n = 4096

    def unit(k):
        v = rng.standard_normal((k, 3)).astype(np.float32)
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    def lights(k):
        rows = rng.uniform(-3, 3, (k, 12)).astype(np.float32)
        rows[:, 3] = rng.uniform(0.3, 0.9, k)      # range or outer cos
        rows[:, 7] = rng.uniform(1, 20, k)         # brightness
        rows[:, 8:11] = unit(k)                    # spot direction
        return rows
    extra = rng.uniform(0.1, 0.4, (2, 4)).astype(np.float32)
    direc = np.concatenate([unit(1)[0], [1.5], [1, 0.9, 0.8], [0, 1, 1]]
                           ).astype(np.float32)
    args = dict(
        world_pos=rng.uniform(-2, 2, (n, 3)).astype(np.float32),
        normal=unit(n), albedo=rng.uniform(0, 1, (n, 3)).astype(np.float32),
        roughness=rng.uniform(0.05, 1, n).astype(np.float32),
        metalness=rng.uniform(0, 1, n).astype(np.float32),
        emissive=rng.uniform(0, 0.2, (n, 3)).astype(np.float32),
        ao=rng.uniform(0, 0.1, n).astype(np.float32),
        camera_pos=np.array([0, 1.5, -5], np.float32),
        point_lights=lights(3), spot_lights=lights(2), spot_extra=extra,
        directional=direc, point_casters=lights(2),
        point_shadow=rng.uniform(0, 1, (2, n)).astype(np.float32),
        spot_casters=lights(2), spot_caster_extra=extra,
        spot_shadow=rng.uniform(0, 1, (2, n)).astype(np.float32),
        dir_shadow=rng.uniform(0, 1, n).astype(np.float32))
    ref = np.asarray(js_.shade_forward(**{k: jnp.asarray(v)
                                          for k, v in args.items()}))
    out = ts_.shade_forward(**{k: torch.from_numpy(v)
                               for k, v in args.items()}).numpy()
    np.testing.assert_allclose(out, ref, rtol=5e-4, atol=1e-6)


def test_pair_bucket_follows_reference():
    """The sticky demand-sized pair bucket, on a sequence of measured
    (demand, overflow) frames, against VQRendererTPU._update_pair_bucket."""
    t = 300_000
    ref = VQRendererTPU()
    ref._scene = types.SimpleNamespace(num_tris_live=t)
    port = VQRendererTorch(CPU)
    port.scene = types.SimpleNamespace(num_tris_live=t)
    frames = [(5000, 0), (90_000, 0), (40_000, 0), (150_000, 0),
              (150_000, 7), (20_000, 0)]
    for demand, dropped in frames:
        ov = np.array([dropped, 0, 0], np.int32)
        ref._update_pair_bucket({"pair_demand": np.int32(demand), "overflow": ov})
        port._update_pair_bucket({"pair_demand": torch.tensor(demand),
                                  "overflow": torch.from_numpy(ov)})
        assert port.pair_bucket == ref._pair_bucket
