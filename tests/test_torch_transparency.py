"""Parity of the port's transparent pass and alpha-mask peel with the JAX
package on the CPU: kernel K1's depth-bounded variants (plain version, in
both sample modes), graph.transparent_pass inside render_forward (with and
without MSAA), graph._alpha_mask_peel called directly, and the
tests/test_transparency.py::TestTransparentPass assertions on the port.

Each side builds its scenes with its own host modules, from the scenes of
tests/test_transparency.py (128x96, camera at z = -4, one directional
light): the glass quad over a red floor, and a second glass quad behind the
first, so that the transparent pass's second layer is not empty. The
reference runs op by op at these shapes only, its raster kernels compiled
whole (test_torch_slice.compiled_rasters: an interpret-mode kernel body is
compiled in either case, so the outputs are the op-by-op call's bit for
bit), its sparse ops and edge score too (test_torch_msaa._EXACT: they
round nothing); the frames of a scene share module-scoped fixtures.
Crafted records (ops/raster_probes.bounded_probe) put fragments exactly on
the window's bounds.

Tolerances: kernel outputs bitwise (the plain version mirrors the
reference's arithmetic); each layer's and the peel's shading inputs
bitwise or within 1e-6 (wpos: the unprojection), the layers' colors within
1e-6 and frames' ldr within 3e-4 (the reference's multichip bar,
tests/test_multichip.py:73; the two libraries' sqrt, exp and division
differ in the last ulp)."""
import contextlib
import types

import jax
import numpy as np
import pytest
import torch

from test_torch_msaa import _EXACT, _jax_binned
from test_torch_slice import compiled_rasters
from vqengine_tpu.ops import raster as jr
from vqengine_tpu.ops import shading as jsh
from vqengine_tpu.render import graph as jg
from vqengine_tpu.render import scene_buffers as jsb
from vqengine_tpu.render.renderer import VQRendererTPU
from vqengine_tpu.scene import camera as jcam
from vqengine_tpu.scene import light as jlight
from vqengine_tpu.scene import material as jmat
from vqengine_tpu.scene import mesh as jmesh
from vqengine_tpu.utils import math3d as jm3
from vqengine_tpu_torch.ops import raster as tr
from vqengine_tpu_torch.ops import raster_probes
from vqengine_tpu_torch.ops.ibl import procedural_sky_equirect
from vqengine_tpu_torch.render import graph as tg
from vqengine_tpu_torch.render import scene_buffers as tsb
from vqengine_tpu_torch.render.renderer import (VQRendererTorch,
                                                frame_constants_numpy)
from vqengine_tpu_torch.scene import camera as tcam
from vqengine_tpu_torch.scene import light as tlight
from vqengine_tpu_torch.scene import material as tmat
from vqengine_tpu_torch.scene import mesh as tmesh
from vqengine_tpu_torch.utils import math3d as tm3

torch.set_num_threads(1)

CPU = torch.device("cpu")
W, H = 128, 96            # every frame of this module, as the reference's
LDR_TOL = 3e-4            # the multichip bar of the reference
HDR_TOL = 1e-6

JAX = types.SimpleNamespace(sb=jsb, cam=jcam, light=jlight, mat=jmat,
                            mesh=jmesh, m3=jm3)
PORT = types.SimpleNamespace(sb=tsb, cam=tcam, light=tlight, mat=tmat,
                             mesh=tmesh, m3=tm3)

GREEN, BLUE, RED = (0.05, 0.9, 0.05), (0.05, 0.05, 0.9), (0.9, 0.05, 0.05)
# (name, quad scale, position, diffuse, alpha[, degrees about z]):
# tests/test_transparency.py's test_blend_over_opaque, and the same with a
# second glass quad behind the first, turned so that its edges cross pixels
# at every offset (a two-layer overlap); the cutout scene's two front quads
# fail the alpha test (< 0.01), the second one behind part of the first
SCENES = {
    "glass_over_floor": [("front", 1.5, (0, 0, 0), GREEN, 0.5),
                         ("back", 3.0, (0, 0, 2.0), RED, 1.0)],
    "two_glass": [("front", 1.5, (0, 0, 0), GREEN, 0.5),
                  ("middle", 2.2, (0.45, 0.25, 1.0), BLUE, 0.4, 12.0),
                  ("back", 3.0, (0, 0, 2.0), RED, 1.0)],
    "cutout": [("front", 1.5, (0, 0, 0), GREEN, 0.005),
               ("middle", 1.0, (0.5, 0.3, 1.0), BLUE, 0.004),
               ("back", 3.0, (0, 0, 2.0), RED, 1.0)],
}


@pytest.fixture(scope="module", autouse=True)
def compiled_exact_ops():
    """The reference's ops/sparse.py and edge score compiled whole (as in
    tests/test_torch_msaa.py; they round nothing)."""
    orig = [(mod, name, getattr(mod, name)) for mod, name, _ in _EXACT]
    for mod, name, static in _EXACT:
        setattr(mod, name, jax.jit(getattr(mod, name), static_argnames=static))
    yield
    for mod, name, fn in orig:
        setattr(mod, name, fn)


def bits(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def assert_bitwise(out, ref, what=""):
    out, ref = bits(out), bits(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    np.testing.assert_array_equal(out, ref, what)


def assert_close(out, ref, tol, what=""):
    out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=0, atol=tol,
                               err_msg=what)


def build(pkg, name: str):
    """SCENES[name] on one package's host modules -> (SceneBuffers, camera,
    lights), as tests/test_transparency.py builds its scenes."""
    items, mats = [], []
    for i, (item, scale, pos, diffuse, alpha, *turn) in enumerate(SCENES[name]):
        m = pkg.mat.Material(name=item)
        m.diffuse = np.asarray(diffuse, np.float32)
        m.alpha = alpha
        mats.append(m)
        rot = pkg.m3.quat_from_axis_angle(np.array([0, 0, 1.0], np.float32),
                                          np.deg2rad(turn[0] if turn else 0.0))
        items.append(pkg.sb.DrawItem(item, pkg.mesh.quad(scale), pkg.m3.Transform(
            position=np.array(pos, np.float32), rotation=rot), i, i))
    p = pkg.cam.FCameraParameters()
    p.position = np.array([0.0, 0.0, -4.0], np.float32)
    p.fov_v_deg = 60.0
    p.near_z = 0.1
    p.far_z = 100.0
    light = pkg.light.Light(
        type=pkg.light.ELightType.DIRECTIONAL, brightness=2.5,
        rotation=pkg.m3.quat_from_axis_angle(np.array([1.0, 0, 0], np.float32),
                                             0.9))
    return (pkg.sb.build_scene_buffers(items, mats),
            pkg.cam.Camera(p, aspect=W / H), [light])


def port_scene(name: str, split: bool = True):
    """-> (opaque DeviceScene, transparent DeviceScene or None,
    FrameConstants) on the CPU; unsplit, the whole scene is the first."""
    buffers, cam, lights = build(PORT, name)
    opaque, transparent = (tsb.split_transparent(buffers) if split
                           else (buffers, None))
    consts = tg.frame_constants_from_numpy(
        frame_constants_numpy(buffers, cam, lights), CPU)
    return (tg.upload_scene(opaque, CPU, bucketize=False),
            None if transparent is None
            else tg.upload_scene(transparent, CPU, bucketize=False), consts)


def jax_scene(name: str, split: bool = True):
    buffers, cam, lights = build(JAX, name)
    opaque, transparent = (jsb.split_transparent(buffers) if split
                           else (buffers, None))
    return (jg.upload_scene(opaque, bucketize=False),
            None if transparent is None
            else jg.upload_scene(transparent, bucketize=False),
            VQRendererTPU().build_frame_constants(buffers, cam, lights))


@contextlib.contextmanager
def recording(calls: dict):
    """While the context lasts, the reference's bounded K1 launches (their
    outputs) and shade_forward calls (their colors) are appended to
    calls["layers"] and calls["shade"]."""
    k1, shade = jr.rasterize_gbuf, jsh.shade_forward

    def k1_rec(binned, width, height, msaa=False, zbound=None):
        out = k1(binned, width, height, msaa=msaa, zbound=zbound)
        if zbound is not None:
            calls["layers"].append(out)
        return out

    def shade_rec(**kw):
        out = shade(**kw)
        calls["shade"].append(out)
        return out
    jr.rasterize_gbuf, jsh.shade_forward = k1_rec, shade_rec
    try:
        yield
    finally:
        jr.rasterize_gbuf, jsh.shade_forward = k1, shade


@pytest.fixture(scope="module", params=["glass_over_floor", "two_glass"])
def frames(request):
    """Both sides' frames of one scene with its transparent part, without
    and with MSAA (the default neighbor edge resolve), the reference's
    layers recorded, the port's from transparent_layers on the frame's
    opaque depth."""
    name = request.param
    ps, pt, pc = port_scene(name)
    js, jt, jc = jax_scene(name)
    assert pt is not None and jt is not None
    out = {}
    for msaa in (False, True):
        calls = {"layers": [], "shade": []}
        with compiled_rasters(), recording(calls):
            ref = jg.render_forward(js, jc, W, H, enable_shadows=False,
                                    scene_transparent=jt, msaa=msaa)
        port = tg.render_forward(ps, pc, W, H, enable_shadows=False,
                                 scene_transparent=pt, msaa=msaa)
        layers = tg.transparent_layers(pt, pc, port["depth"], W, H)
        out[msaa] = dict(ref=ref, port=port, layers=layers,
                         ref_layers=calls["layers"],
                         ref_colors=calls["shade"][-len(layers):])
    return name, out


@pytest.mark.parametrize("msaa", [False, True])
def test_transparent_frame_matches_jax(frames, msaa):
    """The opaque depth and tri_id bitwise, each transparent layer's depth
    and tri_id bitwise and its color within HDR_TOL where it has a
    fragment, the frame's hdr within HDR_TOL and ldr within LDR_TOL."""
    name, f = frames
    f = f[msaa]
    port, ref = f["port"], f["ref"]
    assert_bitwise(port["depth"], ref["depth"], "opaque depth")
    assert_bitwise(port["tri_id"], ref["tri_id"], "opaque tri_id")
    assert len(f["ref_layers"]) == len(f["layers"]) == 2
    for k, (layer, rl, rc) in enumerate(zip(f["layers"], f["ref_layers"],
                                            f["ref_colors"])):
        assert_bitwise(layer["depth"], rl[0], f"layer {k} depth")
        assert_bitwise(layer["tri_id"], rl[1], f"layer {k} tri_id")
        m = layer["mask"].numpy()
        assert_close(layer["color"][m], np.asarray(rc)[m], HDR_TOL,
                     f"layer {k} color")
    pixels = [int(layer["mask"].sum()) for layer in f["layers"]]
    assert pixels[0] > 500
    assert (pixels[1] > 100) == (name == "two_glass"), pixels
    assert_close(port["hdr"], ref["hdr"], HDR_TOL, "hdr")
    assert_close(port["ldr"], ref["ldr"], LDR_TOL, "ldr")


def test_transparent_pass_blends_layers(frames):
    """The port's frame without its transparent part differs from the
    frame with it exactly where the first layer has a fragment of nonzero
    alpha (the second layer lies behind first-layer fragments only)."""
    name, f = frames
    f = f[False]
    ps, _, pc = port_scene(name)
    base = tg.render_forward(ps, pc, W, H, enable_shadows=False)
    layer0, layer1 = f["layers"]
    seen = layer0["mask"] & (layer0["alpha"] > 0)
    assert torch.equal((f["port"]["hdr"] != base["hdr"]).any(-1), seen)
    assert bool((~layer1["mask"] | layer0["mask"]).all())


def _layer_windows(name: str):
    """The transparent binning of a scene and its two layer windows, as
    the frames' transparent pass makes them (port side)."""
    ps, pt, pc = port_scene(name)
    depth = tg.geometry_pass(ps, pc, W, H)[0]
    setup, extra = tg.geometry_setup_gbuf(pt, pc, W, H)
    binned = tr.bin_triangles(setup, W, H, extra=extra)
    d1 = tr.rasterize_gbuf(binned, W, H, zbound=(torch.full_like(depth, -1.0),
                                                 depth))[0]
    return binned, [(torch.full_like(depth, -1.0), depth), (d1, depth)]


def _kernel_pair(pb, width, height, msaa, zbound):
    """The port's plain bounded K1 and the reference's bounded kernel on
    the same binning and window, compared bitwise -> the port's outputs."""
    out = tr.rasterize_gbuf(pb, width, height, msaa=msaa, zbound=zbound)
    with compiled_rasters():
        ref = jr.rasterize_gbuf(_jax_binned(pb), width, height, msaa=msaa,
                                zbound=tuple(z.numpy() for z in zbound))
    names = ("depth", "tri_id", "gbuf", "coverage")
    assert len(out) == len(ref) == (4 if msaa else 3)
    for what, a, b in zip(names, out, ref):
        assert_bitwise(a, b, what)
    return out


@pytest.mark.parametrize("msaa", [False, True])
def test_rasterize_gbuf_bounded_matches_jax(msaa):
    """K1-bounded's plain version against the reference's bounded kernel,
    bitwise in both sample modes, on the two-glass scene's transparent
    binning with both layer windows (the quads' silhouettes cross the
    window's bounds; with MSAA, partly covered pixels)."""
    pb, windows = _layer_windows("two_glass")
    changed = 0
    for zbound in windows:
        out = _kernel_pair(pb, W, H, msaa, zbound)
        free = tr.rasterize_gbuf(pb, W, H, msaa=msaa)
        changed += int((out[1] != free[1]).sum())
        if msaa:
            n = out[3].sum(0)
            assert int(((n > 0) & (n < 4)).sum()) > 0
    assert changed > 100


@pytest.mark.parametrize("msaa", [False, True])
def test_rasterize_gbuf_bounded_probe_matches_jax(msaa):
    """K1-bounded's plain version against the reference on
    ops/raster_probes.bounded_probe's records and windows, bitwise: z on
    zlo and on zhi, empty windows (zlo > zhi, zlo = zhi), ties inside the
    window in one group and across tiers, sample-only fragments cut by the
    window, a ragged frame. Each class's winners are those the strict
    window and the first-in-stream tie-break give."""
    pb, zbound, cls = raster_probes.bounded_probe()
    w, h = raster_probes.BOUNDED_W, raster_probes.BOUNDED_H
    out = _kernel_pair(pb, w, h, msaa, zbound)
    row = torch.where((out[1] >= 0) & (out[1] < raster_probes.GLOBAL_ID),
                      out[1] % tr.GROUP, out[1])
    gid = raster_probes.GLOBAL_ID

    def winners(c):
        return set(torch.unique(row[cls == c]).tolist())
    assert winners(3) == winners(7) == winners(10) == {-1}   # empty
    assert winners(1) <= {3} | set(range(5, 12))      # band 0 on zlo
    assert winners(2) == {0, 1}                       # 0.25 on zlo, 0.5 tie
    assert winners(4) == {1, gid} and winners(5) == {3} and winners(6) == {0}
    assert winners(8) == {-1, 0} and winners(9) == {0, gid}   # 0.75 tie
    assert winners(11) == {-1} | set(range(4, 12))
    assert winners(12) == {-1} | set(range(5, 12))
    assert winners(13) == {-1} | set(range(4, 8))
    if msaa:
        # sample-only winners: the center of no record inside the window
        center = tr.rasterize_gbuf(pb, w, h, zbound=zbound)[1]
        assert int(((out[1] >= 0) & (center < 0)).sum()) > 0
        n = out[3].sum(0)
        assert int(((n > 0) & (n < 4)).sum()) > 0


@pytest.fixture(scope="module")
def material_alpha_of_rows(request):
    """The reference's material_pass returns "alpha" only with textures:
    the row's alpha for a material without a diffuse or alpha-mask map
    (vqengine_tpu/render/graph.py:660-661). Without textures the port
    returns that value; the reference gets it here for the module."""
    orig = jg.material_pass

    def with_alpha(*args, **kw):
        out = orig(*args, **kw)
        out.setdefault("alpha", kw["mrow"][..., 3])
        return out
    jg.material_pass = with_alpha
    yield
    jg.material_pass = orig


@pytest.mark.parametrize("msaa", [False, True])
def test_alpha_mask_peel_matches_jax(material_alpha_of_rows, msaa):
    """_alpha_mask_peel on both sides, on the unsplit cutout scene (two
    quads with alpha below 0.01 in front of an opaque floor): where the
    front quad fails, the next surface is the floor (passing) or the
    middle quad (failing again: background). Depth, tri_id, mask, the
    material keys and, with MSAA, the per-sample coverage bitwise; wpos
    and n within HDR_TOL."""
    ps, _, pc = port_scene("cutout", split=False)
    js, _, jc = jax_scene("cutout", split=False)
    depth, tri_id, attrs, mask, cov, binned = tg.geometry_pass(
        ps, pc, W, H, msaa=msaa, return_binned=True)
    mat = tg.material_pass(tg.unit3(attrs["wnrm"]), attrs["mrow"], attrs["ids"])
    out = tg._alpha_mask_peel(ps, pc, binned, W, H, depth, tri_id, mask,
                              attrs["wpos"], mat["normal"], mat, cov)
    with compiled_rasters():
        jd, jt, ja, jmask, jcov, jb = jg.geometry_pass(
            js, jc, W, H, msaa=msaa, return_binned=True)
        wn = ja["wnrm"]
        wn = wn / jax.numpy.maximum(
            jax.numpy.linalg.norm(wn, axis=-1, keepdims=True), 1e-9)
        jmat_ = jg.material_pass(js, jt, uv=ja["uv"], wnrm=wn,
                                 wtan=ja["wtan"], mrow=ja["mrow"],
                                 ids=ja["ids"])
        ref = jg._alpha_mask_peel(js, jc, jb, W, H, jd, jt, jmask, ja["wpos"],
                                  jmat_["normal"], jmat_, jcov, None, 0, None,
                                  None)
    assert_bitwise(depth, jd, "depth before")
    for what, a, b in zip(("depth", "tri_id", "mask"), out[:3], ref[:3]):
        assert_bitwise(a, b, what)
    assert_close(out[3], ref[3], HDR_TOL, "wpos")
    assert_close(out[4], ref[4], HDR_TOL, "n")
    for k in tg.MATERIAL_PEEL_KEYS:
        assert_bitwise(out[5][k], ref[5][k], k)
    if msaa:
        assert_bitwise(out[6], ref[6], "coverage")
    else:
        assert out[6] is None and ref[6] is None
    fail = mask & (mat["alpha"] < 0.01)
    peeled_tri, peeled_mask = out[1], out[2]
    assert int(fail.sum()) > 500
    assert bool((peeled_tri[fail] >= 0).any())        # the floor revealed
    assert bool((~peeled_mask[fail]).any())           # failed twice
    assert bool((out[5]["object_id"][fail & peeled_mask] == 2).all())


# tests/test_transparency.py::TestTransparentPass on the port

def test_split():
    glass = tmat.Material(name="glass")
    glass.alpha = 0.4
    solid = tmat.Material(name="solid")
    items = [
        tsb.DrawItem("a", tmesh.cube(), tm3.Transform(), 0, 0),
        tsb.DrawItem("b", tmesh.cube(), tm3.Transform(
            position=np.array([2, 0, 0], np.float32)), 1, 1),
    ]
    buffers = tsb.build_scene_buffers(items, [glass, solid])
    opaque, transparent = tsb.split_transparent(buffers)
    assert transparent is not None
    total = buffers.indices.shape[0]
    assert opaque.indices.shape[0] + transparent.indices.shape[0] == total
    assert (transparent.tri_item == 0).all()


def test_no_transparent_materials():
    items = [tsb.DrawItem("a", tmesh.cube(), tm3.Transform(), 0, 0)]
    buffers = tsb.build_scene_buffers(items, [tmat.Material(name="m")])
    opaque, transparent = tsb.split_transparent(buffers)
    assert transparent is None
    assert opaque is buffers


def test_blend_over_opaque():
    """A 50%-alpha green quad in front of a red floor must blend: the pixel
    is neither pure floor nor pure quad color; through the renderer, which
    splits the scene itself."""
    buffers, cam, lights = build(PORT, "glass_over_floor")
    r = VQRendererTorch(CPU)
    r.load_scene(buffers)
    assert r.scene_t is not None
    consts = r.build_frame_constants(buffers, cam, lights)
    ldr = r.render(consts, W, H, enable_shadows=False)["ldr"].numpy()
    scene, _, c = port_scene("glass_over_floor")
    base = tg.render_forward(scene, c, W, H, enable_shadows=False)["ldr"].numpy()
    cy, cx = H // 2, W // 2
    px, px0 = ldr[cy, cx], base[cy, cx]
    assert px[1] > px0[1] + 0.02, "no green contribution from the glass"
    assert px[0] > 0.05, "floor red fully lost: blend looks opaque"


@pytest.mark.parametrize("kw", [dict(env=object()), dict(textures=object()),
                                dict(full_height=2 * H), dict(y_offset=H)])
def test_transparent_pass_unported_raise(kw):
    """Textures and multichip bands of the reference's transparent_pass
    are later slices: they raise. The environment term is ported (IBL):
    with a small procedural sky's maps the layers are lit by it, so the
    pass changes the glass's pixels and no others
    (tests/test_torch_ibl.py holds it against the reference)."""
    _, pt, pc = port_scene("glass_over_floor")
    hdr = torch.zeros((H, W, 3))
    if "env" in kw:
        env = tg.build_environment(procedural_sky_equirect(32, 16), CPU,
                                   diffuse_size=4, specular_base=8,
                                   lut_size=16)
        depth = torch.ones((H, W))
        lit = tg.transparent_pass(pt, pc, hdr, depth, W, H, env=env)
        bare = tg.transparent_pass(pt, pc, hdr, depth, W, H)
        glass = tg.transparent_layers(pt, pc, depth, W, H)[0]["mask"]
        assert bool(glass.any()) and bool(torch.isfinite(lit).all())
        assert not torch.equal(lit[glass], bare[glass])
        assert torch.equal(lit[~glass], bare[~glass])
        return
    with pytest.raises(NotImplementedError):
        tg.transparent_pass(pt, pc, hdr, torch.ones((H, W)), W, H, **kw)
