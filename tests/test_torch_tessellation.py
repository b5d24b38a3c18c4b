"""The port's tessellation (vqengine_tpu_torch/ops/tessellation.py, the
geomorph factor and transform, the upload of patch tables and the front
end's amplification) against the reference, run op by op on the CPU.

The amplifier kills a collapsed template triangle by testing its snapped
parameters for equality, so snapped parameters, `collapsed` and `live` must
be bitwise the reference's; so must every factor (an ulp moves the
odd-integer selection n = ceil_odd(f)) and every displacement texel
(recorded on both sides). The corner tables, the geomorph factor (XLA's
log10 bit for bit) and the front end's setup and attribute records are
bitwise too. The properties of tests/test_tessellation.py run on the port.
Every case is small: the file takes about a minute in one process."""
import contextlib
import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from vqengine_tpu.ops import culling as jcull
from vqengine_tpu.ops import raster as jr
from vqengine_tpu.ops import tessellation as jt
from vqengine_tpu.render import graph as jg
from vqengine_tpu.render import scene_buffers as jsb
from vqengine_tpu.render.renderer import VQRendererTPU
from vqengine_tpu.scene import camera as jcam
from vqengine_tpu.scene import light as jlight
from vqengine_tpu.scene import material as jmat
from vqengine_tpu.scene import mesh as jmesh
from vqengine_tpu.scene import scenes as jscenes
from vqengine_tpu.scene import serialization as jser
from vqengine_tpu.scene import texture_manager as jtm
from vqengine_tpu.utils import math3d as jm3
from vqengine_tpu_torch.engine.scene_load import find_data_dirs
from vqengine_tpu_torch.ops import culling as tcull
from vqengine_tpu_torch.ops import raster as tr
from vqengine_tpu_torch.ops import tessellation as tt
from vqengine_tpu_torch.render import graph as tg
from vqengine_tpu_torch.render import scene_buffers as tsb
from vqengine_tpu_torch.render.renderer import (VQRendererTorch,
                                                frame_constants_numpy)
from vqengine_tpu_torch.scene import camera as tcam
from vqengine_tpu_torch.scene import light as tlight
from vqengine_tpu_torch.scene import material as tmat
from vqengine_tpu_torch.scene import mesh as tmesh
from vqengine_tpu_torch.scene import scenes as tscenes
from vqengine_tpu_torch.scene import serialization as tser
from vqengine_tpu_torch.scene import texture_manager as ttm
from vqengine_tpu_torch.utils import math3d as tm3

torch.set_num_threads(1)

CPU = torch.device("cpu")
W, H = 96, 54
F32 = np.float32
M = tt.MAX_SEGS

JAX = types.SimpleNamespace(sb=jsb, cam=jcam, light=jlight, mat=jmat, mesh=jmesh,
                            m3=jm3, tm=jtm, scenes=jscenes, ser=jser)
PORT = types.SimpleNamespace(sb=tsb, cam=tcam, light=tlight, mat=tmat, mesh=tmesh,
                             m3=tm3, tm=ttm, scenes=tscenes, ser=tser)


def bits(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def assert_bitwise(out, ref, what=""):
    out, ref = bits(out), bits(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    np.testing.assert_array_equal(out, ref, what)


def T(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# scenes, each built on its own side's host modules
# ---------------------------------------------------------------------------

def terrain_scene(pkg, patches: int = 4, width: int = W, height: int = H):
    """Data/Levels/Terrain.xml with augment_terrain(patches=...): patches^2
    heightmap-displaced quad patches (the level has 24^2) -> (SceneBuffers,
    cameras, lights)."""
    path = find_data_dirs()[0] / "Levels" / "Terrain.xml"
    rep = pkg.ser.parse_scene_file(path)
    lib, meshes = {}, pkg.mesh.build_builtin_meshes()
    with threadpool_limits(limits=1):
        pkg.scenes.augment_terrain(rep, lib, meshes, patches=patches)
        buffers, cams, lights = pkg.sb.assemble_scene(rep, meshes, lib,
                                                      draw_light_gizmos=True)
    for c in cams:
        c.aspect = width / height
    return buffers, cams, lights


def tess_rock(pkg):
    """StressTest's TessRock material (scenes.augment_stress_test): the
    tri-domain tessellation of an ordinary mesh, displaced by a noise
    heightmap."""
    rock = pkg.mat.Material(name="TessRock")
    rock.diffuse = np.asarray([0.46, 0.41, 0.35], F32)
    rock.roughness = 0.92
    rock.tessellation_enabled = True
    rock.tessellation_scale = 600.0
    rock.displacement = 1.1
    rock.height_map_image = pkg.tm.noise_texture(64, base=0.35, amp=0.35,
                                                 seed=17)[..., 0]
    return rock


def mixed_scene(pkg):
    """Every tessellation path in one scene, so the reference compiles its
    front end once: the Terrain level's quad patches (4 x 4 of them, the
    level's heightmap, displacement and factor scale), the TessRock (12
    displaced tri patches), four geomorph tiles (scenes.build_terrain_patch,
    3 LODs with morph targets) and a plain sphere -> (SceneBuffers, the
    Terrain level's two cameras and one near the rock, lights)."""
    with threadpool_limits(limits=1):
        patches = pkg.mesh.patch_grid(
            1000.0, 1000.0, 4, 4, heightmap=pkg.scenes._cached_heightmap(256),
            disp_scale=60.0, tess_scale=250.0, name="TerrainPatches")
        tiles = [pkg.scenes.build_terrain_patch(i % 2, i // 2, patches=2, res=64,
                                                num_lods=3) for i in range(4)]
        mats = [pkg.mat.Material(name="m"), tess_rock(pkg)]
        tf = pkg.m3.Transform
        items = ([pkg.sb.DrawItem("TerrainPatches", patches, tf(
                      position=np.array([0.0, -20.0, 0.0], F32)), 0, 0),
                  pkg.sb.DrawItem("TessRock0", pkg.mesh.cube(), tf(
                      position=np.array([-300.0, 40.0, -300.0], F32),
                      scale=np.array([8.0, 8.0, 8.0], F32),
                      rotation=pkg.m3.quat_from_euler_xyz_degrees(10, 30, 0)), 1, 1),
                  pkg.sb.DrawItem("ball", pkg.mesh.sphere(6.0, 12, 12), tf(
                      position=np.array([-280.0, 40.0, -310.0], F32)), 0, 2)]
                 + [pkg.sb.DrawItem(f"tile{i}", t, tf(
                      position=np.array([0.0, 30.0, 0.0], F32)), 0, 3 + i)
                    for i, t in enumerate(tiles)])
        buffers = pkg.sb.build_scene_buffers(items, mats)
    cams = []
    for pos, pitch, yaw in (((-420, 140, -420), 14.0, 45.0), ((0, 600, -10), 85.0, 0.0),
                            ((-330, 55, -345), 10.0, 35.0)):
        p = pkg.cam.FCameraParameters()
        p.position = np.array(pos, F32)
        p.pitch_deg, p.yaw_deg = pitch, yaw
        p.near_z, p.far_z = 0.5, 6000.0
        cams.append(pkg.cam.Camera(p, aspect=W / H))
    lights = [pkg.light.Light(type=pkg.light.ELightType.DIRECTIONAL, brightness=1.5,
                              rotation=pkg.m3.quat_from_euler_xyz_degrees(38, 0, -20))]
    return buffers, cams, lights


def both(scene_fn, *a):
    return scene_fn(JAX, *a), scene_fn(PORT, *a)


def consts_pair(jb, jcam_, jl, pb, pcam, pl):
    jc = VQRendererTPU().build_frame_constants(jb, jcam_, jl)
    pc = tg.frame_constants_from_numpy(frame_constants_numpy(pb, pcam, pl), CPU)
    return jc, pc


@contextlib.contextmanager
def recorded_texels():
    """Record the displacement texel selection (x0i, y0i) of every
    displace() call on both sides -> (reference list, port list)."""
    ref, port = [], []
    j_disp, t_texels = jt.displace, tt.displace_texels

    def j_rec(positions, normals, uv, heightmap, scale):
        hh, wh = heightmap.shape
        x = jnp.clip(uv[..., 0] * (wh - 1), 0.0, wh - 1.0)
        y = jnp.clip(uv[..., 1] * (hh - 1), 0.0, hh - 1.0)
        ref.append((np.asarray(jnp.floor(x).astype(jnp.int32)),
                    np.asarray(jnp.floor(y).astype(jnp.int32))))
        return j_disp(positions, normals, uv, heightmap, scale)

    def t_rec(uv, hh, wh):
        out = t_texels(uv, hh, wh)
        port.append((out[0].numpy().astype(np.int32), out[1].numpy().astype(np.int32)))
        return out
    jt.displace, tt.displace_texels = j_rec, t_rec
    try:
        yield ref, port
    finally:
        jt.displace, tt.displace_texels = j_disp, t_texels


def assert_same_texels(ref, port):
    assert len(ref) == len(port) > 0
    for (jx, jy), (px, py) in zip(ref, port):
        assert int((jx != px).sum()) == 0 and int((jy != py).sum()) == 0


# ---------------------------------------------------------------------------
# the snap, the factors and the evaluation, on seeded inputs
# ---------------------------------------------------------------------------

def _factors(rng, n):
    """Random factors in [0.5, 8] plus each odd integer and its f32
    neighbours (the boundaries of n = ceil_odd(f))."""
    odd = np.asarray([1, 3, 5, 7], F32)
    edge = np.concatenate([np.nextafter(odd, F32(0)), odd,
                           np.nextafter(odd, F32(10))]).astype(F32)
    return np.concatenate([rng.uniform(0.5, 8.0, n).astype(F32), edge])


def test_frac_odd_snap_matches():
    rng = np.random.default_rng(0)
    f = _factors(rng, 3000)
    u = (np.arange(M + 1) / M).astype(F32)
    ref = jt.frac_odd_snap(jnp.asarray(u)[None], jnp.asarray(f)[:, None])
    assert_bitwise(tt.frac_odd_snap(T(u)[None], T(f)[:, None]), ref)


@pytest.mark.parametrize("domain", ["quad", "tri"])
@pytest.mark.parametrize("tess_scale", [3.0, 250.0, 600.0])
def test_edge_factors_match(domain, tess_scale):
    """Each factor divides f32(max_segs * tess_scale) by the norm (an FMA
    chain), and the tri inner factor divides by 3: bitwise."""
    rng = np.random.default_rng(1)
    c = rng.normal(size=(64, 4 if domain == "quad" else 3, 3)).astype(F32) * 40
    cam = (rng.normal(size=3) * 60).astype(F32)
    fn_j, fn_t = ((jt.edge_factors, tt.edge_factors) if domain == "quad"
                  else (jt.tri_edge_factors, tt.tri_edge_factors))
    ref = fn_j(jnp.asarray(c), jnp.asarray(cam), tess_scale)
    out = fn_t(T(c), T(cam), tess_scale)
    for i, (a, b) in enumerate(zip(out, ref)):
        assert_bitwise(a, b, f"factor {i}")
    assert min(float(a.min()) for a in out) < 7.0 or tess_scale > 100


def test_snap_params_and_bary_match():
    """Snapped quad parameters and tri barycentrics on factors that cross
    every odd boundary, each edge and the interior on its own factor (16
    quad and 12 tri patches at a time, mixed_scene's counts)."""
    rng = np.random.default_rng(2)
    params, _ = tt.build_patch_template()
    bary, _ = tt.build_tri_template()
    f = rng.permutation(_factors(rng, 468))                    # 480 factors
    for p, fn_j, fn_t, tpl, k in ((16, jt.snap_params, tt.snap_params, params, 5),
                                  (12, jt.snap_bary, tt.snap_bary, bary, 4)):
        for rows in f.reshape(-1, k * p):
            fs = [rng.permutation(r) for r in rows.reshape(k, p)]
            ref = fn_j(jnp.asarray(tpl), *[jnp.asarray(a) for a in fs])
            assert_bitwise(fn_t(T(tpl), *[T(a) for a in fs]), ref)


def test_eval_and_displace_match():
    """Bilinear and barycentric evaluation (the tri einsum an FMA chain,
    more than one patch), and the displacement with every texel recorded."""
    rng = np.random.default_rng(3)
    corners = rng.normal(size=(9, 4, 3)).astype(F32) * 10
    uv01 = rng.random((9, 40, 2)).astype(F32)
    assert_bitwise(tt.eval_patches(T(corners), T(uv01)),
                   jt.eval_patches(jnp.asarray(corners), jnp.asarray(uv01)))
    b = rng.random((9, 36, 3)).astype(F32)
    assert_bitwise(tt.eval_tri_patches(T(corners[:, :3]), T(b)),
                   jt.eval_tri_patches(jnp.asarray(corners[:, :3]), jnp.asarray(b)))
    hm = rng.random((33, 17)).astype(F32)
    # uv past both edges and on texel boundaries
    uv = np.concatenate([rng.uniform(-0.2, 1.2, (9, 30, 2)),
                         np.broadcast_to(np.arange(17)[:, None] / 16.0, (9, 17, 2))],
                        axis=1).astype(F32)
    pos = rng.normal(size=uv.shape[:2] + (3,)).astype(F32)
    nrm = rng.normal(size=pos.shape).astype(F32)
    with recorded_texels() as (rsel, psel):
        ref = jt.displace(jnp.asarray(pos), jnp.asarray(nrm), jnp.asarray(uv),
                          jnp.asarray(hm), 1.3)
        out = tt.displace(T(pos), T(nrm), T(uv), T(hm), 1.3)
    assert_same_texels(rsel, psel)
    assert_bitwise(out, ref)


@pytest.mark.parametrize("patches", [1, 2, 7])
def test_cull_patches_matches(patches):
    """The four-term plane sums (in pairs, an FMA chain for one patch)
    against -slack; corners placed near the planes."""
    rng = np.random.default_rng(4 + patches)
    for _ in range(20):
        planes = rng.normal(size=(6, 4)).astype(F32)
        c = rng.normal(size=(patches, 4, 3)).astype(F32) * 3
        ref = jt.cull_patches(jnp.asarray(c), jnp.asarray(planes), slack=1.3)
        assert_bitwise(tt.cull_patches(T(c), T(planes), slack=1.3), ref)


def _amplify_inputs(rng, p, corners):
    pc = rng.normal(size=(p, corners, 3)).astype(F32) * 10
    pn = rng.normal(size=(p, corners, 3)).astype(F32)
    pn /= np.linalg.norm(pn, axis=-1, keepdims=True)
    pu = rng.random((p, corners, 2)).astype(F32)
    pi = rng.integers(0, 3, p).astype(np.int32)
    world = np.tile(np.eye(4, dtype=F32), (3, 1, 1))
    world[:, :3, :3] = rng.normal(size=(3, 3, 3))
    world[:, :3, 3] = rng.normal(size=(3, 3)) * 5
    planes = rng.normal(size=(6, 4)).astype(F32)
    planes[:, 3] += 30.0
    cam = (rng.normal(size=3) * 20).astype(F32)
    return pc, pn, pu, pi, world, cam, planes


@pytest.mark.parametrize("domain", ["quad", "tri"])
@pytest.mark.parametrize("displaced", [False, True])
def test_amplify_matches(domain, displaced):
    """The whole amplifier on 16 quad or 12 tri patches (mixed_scene's
    counts, so the reference compiles its ops once for both tests) at two
    factor scales: corner positions, normals (from the displaced surface's
    differences), tangents, uvs, items and tri_live bitwise, every texel
    recorded; some triangles collapse and some live."""
    rng = np.random.default_rng(10 + displaced)
    template = tt.build_patch_template() if domain == "quad" else tt.build_tri_template()
    fn_j, fn_t = (jt.amplify, tt.amplify) if domain == "quad" else (jt.amplify_tri,
                                                                   tt.amplify_tri)
    hm = rng.random((33, 33)).astype(F32)
    p = 16 if domain == "quad" else 12
    pc, pn, pu, pi, world, cam, planes = _amplify_inputs(
        rng, p, 4 if domain == "quad" else 3)
    kw = dict(heightmap=hm, disp_scale=1.3) if displaced else {}
    for tess_scale in (4.0, 9.0):
        with recorded_texels() as (rsel, psel):
            ref = fn_j(*[jnp.asarray(a) for a in (pc, pn, pu, pi, world, cam, planes,
                                                  *template)], tess_scale,
                       **{k: jnp.asarray(v) if k == "heightmap" else v
                          for k, v in kw.items()})
            out = fn_t(*[T(a) for a in (pc, pn, pu, pi, world, cam, planes,
                                        *template)], tess_scale,
                       **{k: T(v) if k == "heightmap" else v for k, v in kw.items()})
        if displaced:
            assert_same_texels(rsel, psel)
        for name, a, b in zip(("pos", "nrm", "tan", "uv", "item", "live"), out, ref):
            assert_bitwise(a, b, name)
        live = out[5].numpy()
        assert live.shape[0] % 128 == 0 and 0 < live.sum() < p * template[1].shape[0]


def test_log10_matches_xla():
    """XLA's log10 on the CPU is its log times f32(1 / ln 10): bit for bit
    on 2,000,000 areas over [1e-30, 10] (torch.log10 is not)."""
    rng = np.random.default_rng(5)
    x = np.maximum(rng.random(2_000_000) * 10.0 ** rng.uniform(-30, 1, 2_000_000),
                   1e-30).astype(F32)
    ref = np.asarray(jnp.log10(jnp.asarray(x)))
    assert_bitwise(tcull.log10_xla(T(x)), ref)
    assert (bits(torch.log10(T(x))) != bits(ref)).any()


def test_morph_factor_and_transform_match():
    """tessellation_morph_factor on random LODs and areas (and the
    window's edges), and transform_clip_corners_morph: its [3T, 17] K3
    rows and the lerp, bitwise."""
    rng = np.random.default_rng(6)
    n = 4000
    num_lods = rng.integers(1, 5, n).astype(np.int32)
    lod = np.minimum(rng.integers(0, 5, n), num_lods - 1).astype(np.int32)
    area = (10.0 ** rng.uniform(-6, 0.7, n)).astype(F32)
    area[:8] = 10.0 ** -np.arange(1, 9, dtype=np.float64)
    ref = jcull.tessellation_morph_factor(jnp.asarray(lod), jnp.asarray(area),
                                          jnp.asarray(num_lods))
    out = tcull.tessellation_morph_factor(T(lod), T(area), T(num_lods))
    assert_bitwise(out, ref)
    assert 0 < int(((out > 0) & (out < 1)).sum()) < n
    t, items = 300, 5
    pos = rng.normal(size=(3 * t, 3)).astype(F32) * 20
    mid = pos + rng.normal(size=pos.shape).astype(F32)
    ti = rng.integers(0, items, t).astype(np.int32)
    mvps = rng.normal(size=(items, 4, 4)).astype(F32)
    w = rng.random(items).astype(F32)
    ref = jr.transform_clip_corners_morph(*[jnp.asarray(a) for a in (pos, mid, ti, mvps, w)])
    assert_bitwise(tr.transform_clip_corners_morph(*[T(a) for a in (pos, mid, ti, mvps, w)]),
                   ref)


# ---------------------------------------------------------------------------
# upload and the front end on each side's own scenes
# ---------------------------------------------------------------------------

def _assert_uploads_match(jb, pb):
    ref = jg.upload_scene(jb)
    out = tg.upload_scene(pb, CPU)
    assert out.num_tris_live == ref.num_tris_live
    for f in dataclasses.fields(out):
        a, b = getattr(out, f.name), getattr(ref, f.name)
        assert (a is None) == (b is None), f.name
        if isinstance(a, torch.Tensor):
            assert_bitwise(a, b, f.name)
        elif a is not None:
            assert a == b, f.name
    return ref, out


def _assert_setups_match(jscene, jc, pscene, pc):
    jset, jext = jg.geometry_setup_gbuf(jscene, jc, W, H)
    pset, pext = tg.geometry_setup_gbuf(pscene, pc, W, H)
    for f in dataclasses.fields(pset):
        assert_bitwise(getattr(pset, f.name), getattr(jset, f.name), f.name)
    assert_bitwise(pext, jext, "extra")
    return pset


@pytest.fixture(scope="module")
def mixed():
    """mixed_scene on both sides, uploaded (the patch tables, templates and
    morph targets bitwise)."""
    (jb, jcs, jl), (pb, pcs, pl) = both(mixed_scene)
    assert pb.patch_corners.shape == (16, 4, 3)
    assert pb.tpatch_corners.shape == (12, 3, 3) and pb.morph_mid is not None
    jscene, pscene = _assert_uploads_match(jb, pb)
    return jb, jcs, jl, jscene, pb, pcs, pl, pscene


@pytest.mark.parametrize("camera", [0, 1, 2])
def test_front_end_matches(mixed, camera):
    """The front end of mixed_scene from the Terrain level's two cameras
    (the second top-down, pitch 85: the far factors) and one near the
    rock: the geomorph factor and its [3T, 17] K3 rows, both amplifiers
    (1,568 quad and 588 tri triangles, each set padded to 128), the
    setup and attribute records, bitwise, with every displacement texel
    recorded; some amplified triangles live."""
    jb, jcs, jl, jscene, pb, pcs, pl, pscene = mixed
    jc, pc = consts_pair(jb, jcs[camera], jl, pb, pcs[camera], pl)
    with recorded_texels() as (rsel, psel):
        setup = _assert_setups_match(jscene, jc, pscene, pc)
    assert_same_texels(rsel, psel)
    tl = pscene.num_tris_live
    assert setup.valid.shape[0] == tl + 13 * 128 + 5 * 128
    assert int(setup.valid[tl:].sum()) > 0


# ---------------------------------------------------------------------------
# tests/test_tessellation.py's properties, on the port
# ---------------------------------------------------------------------------

def _render(items, materials, w=160, h=96, eye=(0.0, 2.5, -3.0)):
    buffers = tsb.build_scene_buffers(items, materials)
    scene = tg.upload_scene(buffers, CPU, bucketize=False)
    p = tcam.FCameraParameters()
    p.position = np.array(eye, F32)
    p.pitch_deg = 35.0
    p.near_z, p.far_z = 0.1, 100.0
    cam = tcam.Camera(p, aspect=w / h)
    consts = VQRendererTorch(CPU).build_frame_constants(
        buffers, cam, [tlight.Light(type=tlight.ELightType.DIRECTIONAL,
                                    brightness=1.5)])
    out = tg.render_forward(scene, consts, w, h)
    return buffers, out["ldr"].numpy(), out["depth"].numpy()


def _render_mesh(mesh):
    _, ldr, depth = _render([tsb.DrawItem("t", mesh, tm3.Transform(), 0, 0)],
                            [tmat.Material(name="m")])
    return ldr, depth


def test_frac_odd_endpoints_and_uniform_top():
    u = T((np.arange(M + 1) / M).astype(F32))
    p1 = tt.frac_odd_snap(u, torch.tensor(1.0)).numpy()
    assert set(np.unique(p1)) <= {0.0, 1.0}
    pm = tt.frac_odd_snap(u, torch.tensor(float(M))).numpy()
    np.testing.assert_allclose(pm, np.arange(M + 1) / M, atol=1e-6)


def test_frac_odd_continuous_in_factor():
    u = T((np.arange(M + 1) / M).astype(F32))
    prev = None
    for f in np.linspace(1.0, float(M), 121):
        p = tt.frac_odd_snap(u, torch.tensor(f, dtype=torch.float32)).numpy()
        assert (np.diff(p) >= -1e-6).all()
        if prev is not None:
            assert np.abs(p - prev).max() < 0.08, (f, p, prev)
        prev = p


_FAR_PLANES = np.tile(np.asarray([[0, 0, 0, 1e9]], F32), (6, 1))


@pytest.mark.parametrize("domain", ["quad", "tri"])
def test_shared_edge_crack_free(domain):
    """Two patches sharing an edge (the tri ones in opposite orientations)
    snap to identical vertices along it for an asymmetric camera."""
    if domain == "quad":
        corners = np.asarray([[[0, 0, 0], [1, 0, 0], [0, 0, 1], [1, 0, 1]],
                              [[1, 0, 0], [2, 0, 0], [1, 0, 1], [2, 0, 1]]], F32)
        template, fn, cam, scale = tt.build_patch_template(), tt.amplify, (0.3, 2.0, 0.2), 3.0
        on_edge = lambda a: np.abs(a[:, 0] - 1.0) < 1e-6          # noqa: E731
    else:
        corners = np.asarray([[[0, 0, 0], [1, 0, 0], [0, 0, 1]],
                              [[1, 0, 1], [0, 0, 1], [1, 0, 0]]], F32)
        template, fn, cam, scale = tt.build_tri_template(), tt.amplify_tri, (0.27, 1.7, -0.4), 2.5
        on_edge = lambda a: np.abs(a[:, 0] + a[:, 2] - 1.0) < 1e-6  # noqa: E731
    normals = np.broadcast_to(np.asarray([0, 1, 0], F32), corners.shape).copy()
    cp = fn(T(corners), T(normals), T(corners[..., (0, 2)].copy()),
            torch.zeros(2, dtype=torch.int32), torch.eye(4)[None],
            torch.tensor(cam), T(_FAR_PLANES), *[T(a) for a in template],
            tess_scale=scale)[0].numpy()
    t = template[1].shape[0]
    a, b = cp[: 3 * t], cp[3 * t: 6 * t]
    za = np.unique(np.round(a[on_edge(a)][:, 2], 5))
    zb = np.unique(np.round(b[on_edge(b)][:, 2], 5))
    assert len(za) > 2
    np.testing.assert_array_equal(za, zb)


def test_cull_drops_outside_patches():
    planes = np.zeros((6, 4), F32)
    planes[:, 3] = 1e9
    planes[0] = [1, 0, 0, 0]
    corners = np.asarray([[[0, 0, 0], [1, 0, 0], [0, 0, 1], [1, 0, 1]],
                          [[-3, 0, 0], [-2, 0, 0], [-3, 0, 1], [-2, 0, 1]]], F32)
    live = tt.cull_patches(T(corners), T(planes)).numpy()
    assert live[0] and not live[1]


def test_morph_factor_bands():
    m = tcull.tessellation_morph_factor(
        torch.tensor([0, 0, 1, 0], dtype=torch.int32),
        torch.tensor([10.0 ** 0.5, 10.0 ** -1.0, 10.0 ** -1.8, 10.0 ** -1.0]),
        torch.tensor([3, 3, 3, 1], dtype=torch.int32)).numpy()
    assert m[0] == 1.0 and m[1] == 0.0 and m[3] == 1.0
    np.testing.assert_allclose(m[2], 0.5, atol=1e-5)


def test_morph_transform_lerp_ends():
    rng = np.random.default_rng(0)
    pos = rng.random((12, 3)).astype(F32)
    mid = rng.random((12, 3)).astype(F32)
    ti = torch.zeros(4, dtype=torch.int32)
    for w, expect, m in ((1.0, pos, mid), (0.0, mid, mid), (0.3, pos, pos)):
        clip = tr.transform_clip_corners_morph(T(pos), T(m), ti, torch.eye(4)[None],
                                               torch.tensor([w])).numpy()
        np.testing.assert_allclose(clip.reshape(-1, 4)[:, :3], expect, atol=1e-5)


def test_fully_morphed_equals_next_level():
    """The port's terrain tiles keep the CDLOD invariant: level 0 fully
    morphed is level 1's surface."""
    g = tmesh.grid_exact_halving(2.0, 2.0, cells=8, num_lods=2)
    hm = np.random.default_rng(3).random((32, 32)).astype(F32)
    l0, l1 = [tmesh.displace(lv, hm, 1.5) for lv in g.lods]
    mids = tmesh.grid_geomorph_mids(l0.positions, 9, 9).reshape(9, 9, 3)
    g1 = l1.positions.reshape(5, 5, 3)
    np.testing.assert_allclose(mids[::2, ::2], g1, atol=1e-6)
    np.testing.assert_allclose(mids[::2, 1::2], 0.5 * (g1[:, :-1] + g1[:, 1:]), atol=1e-6)


def test_full_factor_is_identity():
    bary, _ = tt.build_tri_template()
    f = torch.full((1,), float(M))
    np.testing.assert_allclose(tt.snap_bary(T(bary), f, f, f, f)[0].numpy(), bary,
                               atol=1e-6)


def test_tri_factor1_collapses_to_corner_fan():
    bary, tri_idx = tt.build_tri_template()
    one = torch.ones(1)
    b = tt.snap_bary(T(bary), one, one, one, one)
    assert int((~tt._collapsed(b, T(tri_idx))).sum()) == 3


@pytest.mark.parametrize("displaced", [False, True])
def test_factor1_matches_untessellated(displaced):
    """tess_scale -> 0 forces factor 1: the amplified quad patches land on
    the control mesh (depth to 1e-6; shading too where undisplaced)."""
    kw = {}
    if displaced:
        kw = dict(heightmap=np.random.default_rng(7).random((32, 32)).astype(F32),
                  disp_scale=0.8)
    patched = tmesh.patch_grid(4.0, 4.0, 3, 3, tess_scale=1e-4, **kw)
    ldr_p, dep_p = _render_mesh(patched)
    ldr_c, dep_c = _render_mesh(tmesh.Mesh("flat", [patched.lods[0]]))
    np.testing.assert_allclose(dep_p, dep_c, atol=1e-6)
    if not displaced:
        np.testing.assert_allclose(ldr_p, ldr_c, atol=2e-3)


def test_material_driven_factor1_matches_plain():
    """A tessellating material promotes every base triangle to a patch
    (num_tris_main 0), and factor 1 renders the plain grid's depth."""
    grid = tmesh.grid(4.0, 4.0, 4, 4)
    t_mat = tmat.Material(name="t")
    t_mat.tessellation_enabled = True
    t_mat.tessellation_scale = 1e-4
    items = [tsb.DrawItem("g", grid, tm3.Transform(), 0, 0)]
    buffers, _, dep_t = _render(items, [t_mat])
    assert buffers.tpatch_corners.shape[0] == grid.lods[0].num_triangles
    assert buffers.num_tris_main == 0
    _, _, dep_p = _render(items, [tmat.Material(name="p")])
    np.testing.assert_allclose(dep_t, dep_p, atol=2e-5)


@pytest.mark.parametrize("domain", ["quad", "tri"])
def test_refinement_with_distance_factors(domain):
    """A working tess_scale moves the displaced surface toward a dense
    factor-1 ground truth, away from the factor-1 render."""
    hm = np.zeros((33, 33), F32)
    hm[12:21, 12:21] = 1.0
    if domain == "quad":
        def depth(scale, cells=2):
            return _render_mesh(tmesh.patch_grid(4.0, 4.0, cells, cells, heightmap=hm,
                                                 disp_scale=0.8, tess_scale=scale))[1]
        dep_c, dep_f, dep_gt = depth(1e-4), depth(40.0), depth(1e-4, 16)
    else:
        def depth(scale):
            m = tmat.Material(name="t")
            m.tessellation_enabled = True
            m.tessellation_scale = scale
            m.displacement = 0.8
            m.height_map_image = hm
            return _render([tsb.DrawItem("g", tmesh.grid(4.0, 4.0, 2, 2),
                                         tm3.Transform(), 0, 0)], [m])[2]
        dep_c, dep_f = depth(1e-4), depth(40.0)
        gt = tmesh.Mesh("gt", [tmesh.displace(tmesh.grid(4.0, 4.0, 16, 16).lods[0],
                                              hm, 0.8)])
        dep_gt = _render_mesh(gt)[1]
    assert np.abs(dep_f - dep_c).max() > 1e-3
    assert np.abs(dep_f - dep_gt).mean() < np.abs(dep_c - dep_gt).mean() * (
        0.5 if domain == "quad" else 1.0)
