"""Parity of the port's image-based lighting and skydome with the JAX
package on the CPU: the IBL half of ops/brdf.py, every function of
ops/ibl.py, graph.build_environment, the sky, and render_forward with an
environment (no MSAA, the MSAA "shade" edge resolve, and a transparent
pass); tests/test_ibl.py's properties on the port; the envmap_unit_test
golden through the port; the environment decode; and the ESM-vs-PCF pins
of tests/test_palette_esm.py and tests/test_shadow.py on the port.

The inputs come from seeds through numpy. The reference runs op by op, at
one set of small shapes (a 64x32 equirect, diffuse cube 8, specular mips
from 16, LUT 32, EnvironmentMapUnitTest at 96x54), its artefacts shared
through module-scoped fixtures; its raster kernels and its exact sparse ops
run compiled whole, which leaves their outputs bit for bit
(test_torch_slice.compiled_rasters, test_torch_msaa._EXACT).

Where the two libraries round differently (torch's atan2, asin and cos
against XLA's CPU calls to libm, the sum order of the load-time products),
the comparison states its tolerance; the frames shade from the reference's
own tables, carried across bit for bit by renderer.environment_from_numpy,
so their bar measures shading-time arithmetic only.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from test_torch_msaa import _EXACT
from test_torch_slice import compiled_rasters, jax_load_scene
from vqengine_tpu.ops import brdf as jb
from vqengine_tpu.ops import ibl as ji
from vqengine_tpu.ops import shadow as jsh
from vqengine_tpu.render import graph as jg
from vqengine_tpu.render import scene_buffers as jsb
from vqengine_tpu.render.renderer import VQRendererTPU
from vqengine_tpu_torch.engine import scene_load
from vqengine_tpu_torch.engine.goldens import golden_scores, render_golden
from vqengine_tpu_torch.ops import brdf as tb
from vqengine_tpu_torch.ops import ibl as ti
from vqengine_tpu_torch.ops import shadow as tsh
from vqengine_tpu_torch.render import graph as tg
from vqengine_tpu_torch.render import scene_buffers as tsb
from vqengine_tpu_torch.render.renderer import (VQRendererTorch,
                                                environment_from_numpy,
                                                frame_constants_numpy)
from vqengine_tpu_torch.scene import mesh as tmesh
from vqengine_tpu_torch.scene.light import ELightType, Light
from vqengine_tpu_torch.utils.image_io import write_hdr

torch.set_num_threads(1)

CPU = torch.device("cpu")
EQ_W, EQ_H = 64, 32
SIZES = dict(diffuse_size=8, specular_base=16, specular_mips=6, lut_size=32)
W, H = 96, 54
LDR_TOL = 3e-4          # the multichip bar of the reference
N = 2048                # random lanes of the per-function tests
YAWS = [0.0, 0.7]       # hdri_yaw 0 makes cos and sin exact: also a turn
# EnvironmentMapUnitTest's spheres made translucent for the transparent
# frame: two of its four metalness rows, so that the transparent part has
# the opaque part's shapes and the reference's transparent front end runs
# on operations already compiled for the opaque one; the camera the frames
# share is nearer than the level's first, so that the 8x4 grid of spheres
# fills much of a 96x54 view
TRANSLUCENT = {f"RoughnessMetallic[{r}][{m}]": alpha
               for m, alpha in ((1, 0.5), (3, 0.35)) for r in range(8)}
CAMERA_POS = (-8.0, 68.0, -55.0)
# the env frames: render flags, and whether the transparent part is drawn
FRAMES = {"plain": ({}, False),
          "msaa_shade": (dict(msaa=True, msaa_edge_resolve="shade"), False),
          "translucent": ({}, True)}


def bits(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def assert_bitwise(out, ref, what=""):
    out, ref = bits(out), bits(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    np.testing.assert_array_equal(out, ref, what)


def f32(a) -> np.ndarray:
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.astype(np.float32)


def max_rel(out, ref) -> float:
    out, ref = f32(out), f32(ref)
    return float((np.abs(out - ref) / np.maximum(np.abs(ref), 1e-30)).max())


def env_leaves(env) -> dict:
    """The JAX package's EnvironmentMaps -> {field: numpy}."""
    return {"equirect": np.asarray(env.equirect),
            "diffuse_cube": np.asarray(env.diffuse_cube),
            "specular_mips": [np.asarray(m) for m in env.specular_mips],
            "brdf_lut": np.asarray(env.brdf_lut),
            "sh_irradiance": np.asarray(env.sh_irradiance),
            "brdf_poly": np.asarray(env.brdf_poly)}


def jax_pyramid_index(offsets, shapes, dirs, level):
    """The reference's flat texel index inside
    ibl.sample_cube_pyramid_nearest (ibl.py:132-141)."""
    face, uv = jsh._cube_face_uv(dirs)
    idx = jnp.zeros(level.shape, jnp.int32)
    for m, (off, shp) in enumerate(zip(offsets, shapes)):
        s = shp[1]
        tx = jnp.clip((uv[..., 0] * s).astype(jnp.int32), 0, s - 1)
        ty = jnp.clip((uv[..., 1] * s).astype(jnp.int32), 0, s - 1)
        idx = jnp.where(level == m, off + (face * s + ty) * s + tx, idx)
    return np.asarray(idx)


@contextlib.contextmanager
def pyramid_fetches(calls: list):
    """While the context lasts, every specular-pyramid fetch of either
    package appends ("jax" | "port", flat texel index) to calls."""
    jfn, tfn = ji.sample_cube_pyramid_nearest, ti.sample_cube_pyramid_nearest

    def jrec(flat, offsets, shapes, dirs, level):
        calls.append(("jax", jax_pyramid_index(offsets, shapes, dirs, level)))
        return jfn(flat, offsets, shapes, dirs, level)

    def trec(flat, offsets, shapes, dirs, level):
        calls.append(("port", ti.cube_pyramid_index(offsets, shapes, dirs,
                                                    level).numpy()))
        return tfn(flat, offsets, shapes, dirs, level)
    ji.sample_cube_pyramid_nearest = jrec
    ti.sample_cube_pyramid_nearest = trec
    try:
        yield
    finally:
        ji.sample_cube_pyramid_nearest = jfn
        ti.sample_cube_pyramid_nearest = tfn


def index_mismatches(calls: list) -> list[int]:
    """Pair the reference's and the port's fetches in call order -> the
    count of lanes whose texel differs, per fetch."""
    ref = [i for who, i in calls if who == "jax"]
    port = [i for who, i in calls if who == "port"]
    assert len(ref) == len(port) and ref, (len(ref), len(port))
    return [int((a.reshape(-1) != b.reshape(-1)).sum()) for a, b in zip(ref, port)]


# ---------------------------------------------------------------------------
# shared artefacts
# ---------------------------------------------------------------------------

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


@pytest.fixture(scope="module")
def sky() -> np.ndarray:
    return ji.procedural_sky_equirect(EQ_W, EQ_H)


@pytest.fixture(scope="module")
def ref_env(sky):
    """The reference's build_environment at this module's sizes."""
    return jg.build_environment(sky, **SIZES)


@pytest.fixture(scope="module")
def port_env(sky):
    return tg.build_environment(sky, CPU, **SIZES)


@pytest.fixture(scope="module")
def carried(ref_env):
    """The reference's tables on the port's side, bit for bit."""
    return environment_from_numpy(env_leaves(ref_env), CPU)


@pytest.fixture(scope="module")
def lanes():
    """Seeded random shading inputs: unit normals and views, roughness
    (a quarter of it on the mip ladder's steps m/5 and the ends),
    metalness, albedo, and the same as jnp arrays."""
    rng = np.random.default_rng(7)

    def unit(n):
        d = rng.normal(size=(n, 3))
        return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    rough = rng.uniform(0, 1, N).astype(np.float32)
    rough[: N // 4] = (rng.integers(0, 6, N // 4) / 5.0).astype(np.float32)
    d = dict(n=unit(N), v=unit(N), rough=rough,
             metal=rng.uniform(0, 1, N).astype(np.float32),
             albedo=rng.uniform(0, 1, (N, 3)).astype(np.float32),
             dirs=(unit(N) * rng.uniform(0.5, 3.0, (N, 1))).astype(np.float32))
    return ({k: torch.from_numpy(v) for k, v in d.items()},
            {k: jnp.asarray(v) for k, v in d.items()})


def _translucent(buffers):
    """TRANSLUCENT's alphas set in the packed materials (either package's
    SceneBuffers)."""
    for name, alpha in TRANSLUCENT.items():
        buffers.materials[buffers.material_names.index(name), 3] = alpha
    return buffers


@pytest.fixture(scope="module")
def frames(ref_env, carried, port_env):
    """EnvironmentMapUnitTest at W x H with TRANSLUCENT's spheres split off,
    on both sides (each side loaded by its own host modules) -> the
    frames "plain" (no MSAA), "msaa_shade" (MSAA, "shade" edge resolve)
    and "translucent" (no MSAA, the transparent pass over the opaque
    part), each lit by the environment: the reference's, the port's on
    the carried tables (and the texel indices of every specular fetch),
    and the port's on its own tables."""
    ps = scene_load.load_scene("EnvironmentMapUnitTest", W, H)
    ps.cameras[0].position = np.asarray(CAMERA_POS, np.float32)
    p_opaque, p_t = tsb.split_transparent(_translucent(ps.buffers))
    tc = tg.frame_constants_from_numpy(
        frame_constants_numpy(ps.buffers, ps.cameras[0], ps.lights), CPU)
    ts, tt = tg.upload_scene(p_opaque, CPU), tg.upload_scene(p_t, CPU)
    b, cams, lights = jax_load_scene("EnvironmentMapUnitTest", W, H)
    cams[0].position = np.asarray(CAMERA_POS, np.float32)
    j_opaque, j_t = jsb.split_transparent(_translucent(b))
    jc = VQRendererTPU().build_frame_constants(b, cams[0], lights)
    js, jt = jg.upload_scene(j_opaque), jg.upload_scene(j_t)
    out = {}
    for name, (kw, transparent) in FRAMES.items():
        calls = []
        with pyramid_fetches(calls):
            with compiled_rasters():
                ref = jg.render_forward(js, jc, W, H, env=ref_env,
                                        scene_transparent=jt if transparent else None,
                                        **kw)
            port = tg.render_forward(ts, tc, W, H, env=carried,
                                     scene_transparent=tt if transparent else None,
                                     **kw)
        own = tg.render_forward(ts, tc, W, H, env=port_env,
                                scene_transparent=tt if transparent else None, **kw)
        out[name] = dict(ref={k: np.asarray(ref[k]) for k in ("ldr", "hdr", "tri_id")},
                         port=port, own=own, mismatches=index_mismatches(calls))
    return out


# ---------------------------------------------------------------------------
# the numpy helpers are the reference's, verbatim
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn,args", [
    ("equirect_texel_directions", (EQ_W, EQ_H)),
    ("cube_texel_directions", (16,)),
    ("procedural_sky_equirect", (EQ_W, EQ_H)),
    ("procedural_sky_equirect_preset", (512, 256))])
def test_numpy_helpers_bitwise(fn, args):
    """The texel directions, solid angles and the procedural sky (at its
    defaults, and shaped as the ProceduralOvercast preset shapes it) are
    bitwise the reference's."""
    kw = {}
    if fn == "procedural_sky_equirect_preset":
        fn, kw = "procedural_sky_equirect", dict(
            sun_dir=(0.5, 0.7, -0.3), sun_intensity=15.625)
    out, ref = getattr(ti, fn)(*args, **kw), getattr(ji, fn)(*args, **kw)
    for o, r in zip(out if isinstance(out, tuple) else (out,),
                    ref if isinstance(ref, tuple) else (ref,)):
        assert_bitwise(o, r, fn)


# ---------------------------------------------------------------------------
# the IBL half of ops/brdf.py
# ---------------------------------------------------------------------------

def test_radical_inverse_and_hammersley_bitwise():
    """The 32-bit bit reversal on int64 masks: every sample index of the
    LUT and the top of the uint32 range, bitwise."""
    i = np.concatenate([np.arange(4096), [2**31 - 1, 2**31, 2**32 - 2,
                                          2**32 - 1, 0x12345678]]).astype(np.uint32)
    out = tb.radical_inverse_vdc(torch.from_numpy(i.astype(np.int64)))
    assert_bitwise(out, jb.radical_inverse_vdc(jnp.asarray(i)))
    k = np.arange(512, dtype=np.uint32)
    assert_bitwise(tb.hammersley(torch.from_numpy(k.astype(np.int64)), 512),
                   jb.hammersley(jnp.asarray(k), 512))


def test_brdf_ibl_terms_bitwise(lanes):
    """reflect (its dot sums left to right, as XLA reduces three terms),
    the IBL Smith terms, fresnel_with_roughness and environment_brdf:
    elementwise in the reference's order, bitwise."""
    t, j = lanes
    assert_bitwise(tb.reflect(-t["v"], t["n"]), jb.reflect(-j["v"], j["n"]), "reflect")
    assert_bitwise(tb.geometry_smith_ibl(t["n"], t["v"], t["dirs"], t["rough"]),
                   jb.geometry_smith_ibl(j["n"], j["v"], j["dirs"], j["rough"]))
    f0 = t["albedo"] * 0.5
    cos = torch.clamp(t["metal"], 0.0, 1.0)
    assert_bitwise(tb.fresnel_with_roughness(cos, f0, t["rough"]),
                   jb.fresnel_with_roughness(jnp.asarray(cos.numpy()),
                                             jnp.asarray(f0.numpy()), j["rough"]))
    irr, spec = t["dirs"].abs(), t["n"].abs() * 3.0
    fsb = torch.stack([t["metal"], t["rough"] * 0.1], dim=-1)
    assert_bitwise(
        tb.environment_brdf(cos, t["rough"], t["metal"], t["albedo"], irr, spec, fsb),
        jb.environment_brdf(jnp.asarray(cos.numpy()), j["rough"], j["metal"],
                            j["albedo"], jnp.asarray(irr.numpy()),
                            jnp.asarray(spec.numpy()), jnp.asarray(fsb.numpy())))


def test_importance_sample_ggx_matches_jax(lanes):
    """GGX half vectors around random normals: torch's cos and sin round
    otherwise than XLA's, and normalize's norm sums in another order; the
    vectors agree within 2e-6."""
    t, j = lanes
    rng = np.random.default_rng(3)
    xi = rng.uniform(0, 1, (N, 2)).astype(np.float32)
    out = tb.importance_sample_ggx(torch.from_numpy(xi), t["n"], t["rough"])
    ref = jb.importance_sample_ggx(jnp.asarray(xi), j["n"], j["rough"])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=2e-6)


def test_brdf_integration_lut_matches_jax(ref_env):
    """The 32^2 LUT of 512 samples accumulated in order, with the compiled
    scan body's contractions and libm's cosf/sinf mirrored: bitwise (within
    1e-5 before it mirrored them)."""
    out = tb.brdf_integration_lut(SIZES["lut_size"], 512, device=CPU)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_env.brdf_lut),
                               rtol=0, atol=1e-5)
    assert np.array_equal(out.numpy().view(np.uint32),
                          np.asarray(ref_env.brdf_lut).view(np.uint32))


def test_brdf_lut_grazing_column_bitwise():
    """The engine's 256^2 LUT of 512 samples: its 8 most grazing NdotV
    columns (from 0.002), where the eager loop's roundings grew to 9.8e-4
    (ROADMAP queue 3, repaired), bitwise against the reference's
    brdf_integration_lut."""
    g = (torch.arange(256, dtype=torch.float32) + 0.5) / 256
    r, nv = torch.meshgrid(g, g[:8], indexing="ij")
    out = tb.integrate_brdf(nv, r, 512).numpy()
    ref = np.asarray(jb.brdf_integration_lut(256, 512))[:, :8]
    assert np.array_equal(out.view(np.uint32), ref.view(np.uint32))


# ---------------------------------------------------------------------------
# ops/ibl.py: maps and samplers
# ---------------------------------------------------------------------------

def test_direction_to_equirect_uv_matches_jax(lanes):
    """u from atan2, w from asin of the normalized y: XLA calls libm's
    atan2f and builds asin on it, torch has its own (measured: ulps in
    about a third of lanes); within 2.5e-7 (two ulps of 0.5)."""
    t, j = lanes
    out = ti.direction_to_equirect_uv(t["dirs"])
    ref = np.asarray(ji.direction_to_equirect_uv(j["dirs"]))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=2.5e-7)


def test_sample_equirect_bilinear_bitwise(carried, ref_env):
    """Bilinear taps of the bf16 equirect at the same uv, also past both
    ends in u (the floor modulo wraps) and v (clamped): bitwise."""
    rng = np.random.default_rng(4)
    uv = rng.uniform(-0.3, 1.3, (N, 2)).astype(np.float32)
    out = ti.sample_equirect_bilinear(carried.equirect, torch.from_numpy(uv))
    assert_bitwise(out, ji.sample_equirect_bilinear(ref_env.equirect, jnp.asarray(uv)))


@pytest.mark.parametrize("bilinear", [True, False])
def test_sample_cube_bitwise(carried, ref_env, lanes, bilinear):
    """The diffuse cube sampled along the same directions: bitwise."""
    t, j = lanes
    out = ti.sample_cube(carried.diffuse_cube, t["dirs"], bilinear=bilinear)
    assert_bitwise(out, ji.sample_cube(ref_env.diffuse_cube, j["dirs"],
                                       bilinear=bilinear))


def test_sample_cube_pyramid_nearest_bitwise(carried, ref_env, lanes):
    """One gather through the flattened specular pyramid at every level:
    the same texel and value as the reference's."""
    t, j = lanes
    level = (np.arange(N) % 6).astype(np.int32)
    flat, offs, shapes = ti.flatten_mip_pyramid(list(carried.specular_mips))
    jflat, joffs, jshapes = ji.flatten_mip_pyramid(list(ref_env.specular_mips))
    assert offs == joffs and [tuple(s) for s in jshapes] == shapes
    out = ti.sample_cube_pyramid_nearest(flat, offs, shapes, t["dirs"],
                                         torch.from_numpy(level))
    assert_bitwise(out, ji.sample_cube_pyramid_nearest(
        jflat, joffs, jshapes, j["dirs"], jnp.asarray(level)))


# ---------------------------------------------------------------------------
# ops/ibl.py: the load-time tables
# ---------------------------------------------------------------------------

def test_downsample_and_cubemap_match_jax(sky):
    """The box downsample (16 texels summed in another order) and the
    mirror cube (bilinear taps at asin-rounded uv) within 2e-6 relative."""
    eq = torch.from_numpy(sky)
    for w in (32, 16):
        assert max_rel(ti.downsample_equirect(eq, w),
                       ji.downsample_equirect(jnp.asarray(sky), w)) < 2e-6, w
    assert max_rel(ti.equirect_to_cubemap(eq, 16),
                   ji.equirect_to_cubemap(jnp.asarray(sky), 16)) < 2e-6


def test_environment_tables_match_jax(port_env, carried, ref_env):
    """build_environment on the port against the reference's
    (graph.environment_differences): the products sum their 512-2,048
    terms in the order XLA's CPU backend sums them (ibl._kernel_products),
    the downsample's blocks row by row and the mirror mip's uv through
    libm's atan2f, so every bf16 table entry is the reference's; SH9, the LUT and the Chebyshev fit within graph.ENV_F32_MAX_REL's
    normwise relative errors (measured 0, 8.0e-6 and 8.3e-5: the
    reference's LUT sums its samples in a compiled lax.scan, whose
    multiply-adds XLA contracts); the fit's surface within 1e-4 of the
    reference's on the LUT's grid."""
    d = tg.environment_differences(port_env, carried)
    print(f"\nport's tables against the reference's: {d}")
    assert d["ok"], d
    bf16 = [k for k in d if k in ("equirect", "diffuse_cube") or k.startswith("specular_mip")]
    assert len(bf16) == 2 + SIZES["specular_mips"]
    assert all(d[k][0] == 0 for k in bf16), d
    g = (np.arange(32, dtype=np.float32) + 0.5) / 32
    nv, r = np.meshgrid(g, g, indexing="xy")
    surf = ti.brdf_poly_eval(port_env.brdf_poly, torch.from_numpy(nv),
                             torch.from_numpy(r))
    ref_surf = ji.brdf_poly_eval(ref_env.brdf_poly, jnp.asarray(nv), jnp.asarray(r))
    np.testing.assert_allclose(surf.numpy(), np.asarray(ref_surf), rtol=0, atol=1e-4)


def test_brdf_poly_fit_bitwise(ref_env):
    """The least-squares fit is the reference's numpy: on the same LUT,
    the same coefficients, bit for bit."""
    lut = np.asarray(ref_env.brdf_lut)
    assert_bitwise(ti.brdf_poly_fit(lut), np.asarray(ref_env.brdf_poly))


def test_sh9_matches_jax(sky, lanes):
    """The SH9 basis (elementwise, bitwise), the projection (numpy on the
    downsampled map, within 1e-5 relative) and its evaluation (a 9-term
    product, within 1e-5 relative)."""
    t, j = lanes
    assert_bitwise(ti.sh9_basis(t["n"]), ji.sh9_basis(j["n"]))
    coeffs = ti.sh9_irradiance_coeffs(torch.from_numpy(sky))
    ref = ji.sh9_irradiance_coeffs(jnp.asarray(sky))
    assert max_rel(coeffs, ref) < 1e-5
    out = ti.sh9_eval(t["n"], torch.from_numpy(np.array(ref)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ji.sh9_eval(j["n"], ref)),
                               rtol=1e-5, atol=1e-7)


def test_brdf_poly_eval_matches_jax(ref_env, lanes):
    """The Chebyshev surface at random (ndotv, roughness), also outside
    [0, 1] (clamped): two 20-term contractions summed in another order
    than XLA's; within 2e-6."""
    t, j = lanes
    x = t["dirs"][:, 0] * 0.6
    out = ti.brdf_poly_eval(torch.from_numpy(np.asarray(ref_env.brdf_poly)),
                            x, t["rough"])
    ref = ji.brdf_poly_eval(ref_env.brdf_poly, jnp.asarray(x.numpy()), j["rough"])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=2e-6)


# ---------------------------------------------------------------------------
# shading-time environment term and the sky
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("yaw", YAWS)
def test_environment_illumination_matches_jax(carried, ref_env, lanes, yaw):
    """The split-sum environment term on random lanes with the carried
    tables, at hdri_yaw 0 and at a turn: every specular fetch reads the
    reference's texel (index mismatches 0), and the term agrees within
    1e-5 relative (the SH9 and Chebyshev contractions, and at a turn the
    rotation's cos and sin, round in the last bits)."""
    t, j = lanes
    calls = []
    with pyramid_fetches(calls):
        out = ti.environment_illumination(
            t["n"], t["v"], t["rough"], t["metal"], t["albedo"],
            carried.diffuse_cube, list(carried.specular_mips), carried.brdf_lut,
            hdri_yaw=torch.tensor(yaw), sh_irradiance=carried.sh_irradiance,
            brdf_poly=carried.brdf_poly)
        ref = ji.environment_illumination(
            j["n"], j["v"], j["rough"], j["metal"], j["albedo"],
            ref_env.diffuse_cube, list(ref_env.specular_mips), ref_env.brdf_lut,
            hdri_yaw=jnp.float32(yaw), sh_irradiance=ref_env.sh_irradiance,
            brdf_poly=ref_env.brdf_poly)
    assert index_mismatches(calls) == [0]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bilinear", [True, False])
@pytest.mark.parametrize("yaw", YAWS)
def test_sky_radiance_matches_jax(carried, ref_env, lanes, bilinear, yaw):
    """The equirect lookup of view rays: bilinear is continuous in uv, so
    the ulps of atan2 and asin (and at a turn, of the rotation) cost at
    most 1e-5 relative (measured 1.3e-6 at yaw 0.7); the nearest
    texel can flip where uv sits on a texel edge, so it must agree on all
    but 0.5% of lanes and exactly there."""
    t, j = lanes
    out = ti.sky_radiance(t["dirs"], carried.equirect, torch.tensor(yaw),
                          bilinear=bilinear).numpy()
    ref = np.asarray(ji.sky_radiance(j["dirs"], ref_env.equirect,
                                     jnp.float32(yaw), bilinear=bilinear))
    if bilinear:
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-7)
    else:
        same = (out == ref).all(axis=-1)
        assert same.mean() >= 0.995, same.mean()


# ---------------------------------------------------------------------------
# tests/test_ibl.py's properties, on the port
# ---------------------------------------------------------------------------

def _prop_equirect_uv_roundtrip():
    dirs, _ = ti.equirect_texel_directions(64, 32)
    uv = ti.direction_to_equirect_uv(torch.from_numpy(dirs)).numpy()
    U, V = np.meshgrid((np.arange(64) + 0.5) / 64, (np.arange(32) + 0.5) / 32)
    np.testing.assert_allclose(uv[:, 0], U.reshape(-1), atol=1e-5)
    np.testing.assert_allclose(uv[:, 1], V.reshape(-1), atol=1e-5)


def _prop_solid_angles_sum_to_sphere():
    _, omega = ti.equirect_texel_directions(128, 64)
    assert omega.sum() == pytest.approx(4 * np.pi, rel=1e-3)


def _prop_cube_dirs_roundtrip_through_face_uv():
    size = 16
    d = ti.cube_texel_directions(size)
    face, uv = tsh._cube_face_uv(torch.from_numpy(d.reshape(-1, 3)))
    face = face.numpy().reshape(6, size, size)
    uv = uv.numpy().reshape(6, size, size, 2)
    t = (np.arange(size) + 0.5) / size
    for f in range(6):
        assert (face[f] == f).all(), f"face {f} misassigned"
        np.testing.assert_allclose(
            uv[f, :, :, 0], np.broadcast_to(t[None, :], (size, size)), atol=1e-5)
        np.testing.assert_allclose(
            uv[f, :, :, 1], np.broadcast_to(t[:, None], (size, size)), atol=1e-5)


def _prop_cube_sample_identity():
    rng = np.random.default_rng(0)
    cube = torch.from_numpy(rng.uniform(0, 1, (6, 8, 8, 3)).astype(np.float32))
    dirs = torch.from_numpy(ti.cube_texel_directions(8))
    out = ti.sample_cube(cube, dirs, bilinear=False)
    np.testing.assert_allclose(out.numpy(), cube.numpy(), atol=1e-6)


def _prop_constant_environment():
    irr = ti.diffuse_irradiance_cube(torch.full((32, 64, 3), 2.0), size=8,
                                     source_width=32)
    np.testing.assert_allclose(irr.numpy(), 2.0, rtol=0.02)


def _prop_single_bright_texel_cosine_lobe():
    env = np.zeros((32, 64, 3), np.float32)
    env[0:2, :, :] = 100.0  # top rows = +Y direction
    irr = ti.diffuse_irradiance_cube(torch.from_numpy(env), size=8,
                                     source_width=64).numpy()
    assert irr[2].mean() > 10 * max(irr[3].mean(), 1e-6)


def _prop_specular_mips_get_blurrier():
    rng = np.random.default_rng(1)
    env = torch.from_numpy(rng.uniform(0, 4, (64, 128, 3)).astype(np.float32))
    mips = ti.specular_prefilter_mips(env, base_size=32, num_mips=4,
                                      source_width=64)
    assert len(mips) == 4
    variances = [float(m.double().var(unbiased=False)) for m in mips]
    assert variances[1] > variances[2] > variances[3]
    means = [float(m.mean()) for m in mips]
    for m in means[1:]:
        assert m == pytest.approx(means[1], rel=0.2)


def _prop_mirror_mip_matches_env():
    env = torch.from_numpy(ti.procedural_sky_equirect(128, 64))
    mips = ti.specular_prefilter_mips(env, base_size=16, num_mips=3,
                                      source_width=64)
    np.testing.assert_allclose(mips[0].numpy(),
                               ti.equirect_to_cubemap(env, 16).numpy(), atol=1e-5)


def _prop_rough_metal_reflects_env_color():
    env = torch.full((32, 64, 3), 1.0) * torch.tensor([4.0, 0.0, 0.0])
    diff = ti.diffuse_irradiance_cube(env, size=8, source_width=32)
    mips = ti.specular_prefilter_mips(env, base_size=16, num_mips=3,
                                      source_width=32)
    lut = tb.brdf_integration_lut(size=16, num_samples=32, device=CPU)
    n = torch.tensor([[0.0, 1.0, 0.0]])
    out = ti.environment_illumination(
        n, n.clone(), torch.tensor([0.5]), torch.tensor([1.0]),
        torch.tensor([[1.0, 1.0, 1.0]]), diff, mips, lut).numpy()
    assert out[0, 0] > 10 * max(out[0, 2], 1e-6)


def _prop_sky_radiance_directional():
    env = np.zeros((32, 64, 3), np.float32)
    env[0:4] = 10.0  # bright top
    env = torch.from_numpy(env)
    up = ti.sky_radiance(torch.tensor([[0.0, 1.0, 0.0]]), env).numpy()
    fwd = ti.sky_radiance(torch.tensor([[1.0, 0.0, 0.0]]), env).numpy()
    assert up[0, 0] > 5.0 and fwd[0, 0] < 1.0


def _prop_sun_and_gradient():
    sky = ti.procedural_sky_equirect(128, 64)
    assert sky.shape == (64, 128, 3)
    assert np.isfinite(sky).all() and (sky >= 0).all()
    assert sky.max() > 10.0
    assert sky[:16].mean() > sky[-16:].mean()


def _prop_sh9_matches_cosine_convolution():
    rng = np.random.default_rng(3)
    env = torch.from_numpy(ti.procedural_sky_equirect(64, 32, sun_intensity=5.0))
    cube = ti.diffuse_irradiance_cube(env, size=8, source_width=64)
    coeffs = ti.sh9_irradiance_coeffs(env, source_width=64)
    dirs = rng.normal(size=(64, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    sh = ti.sh9_eval(torch.from_numpy(dirs), coeffs).numpy()
    ref = ti.sample_cube(cube, torch.from_numpy(dirs)).numpy()
    scale = ref.mean()
    assert scale > 0
    np.testing.assert_allclose(sh, ref, atol=0.12 * scale, rtol=0.25)


def _prop_sh9_constant_env_exact():
    coeffs = ti.sh9_irradiance_coeffs(torch.full((16, 32, 3), 2.0), source_width=32)
    out = ti.sh9_eval(torch.tensor([[0.0, 1.0, 0.0], [1.0, 0.0, 0.0]]), coeffs)
    np.testing.assert_allclose(out.numpy(), 2.0, rtol=0.02)


def _prop_brdf_poly_fit_error_vs_lut():
    lut = ti.brdf_lut_cached(64, num_samples=128, device=CPU).numpy()
    coeffs = torch.from_numpy(ti.brdf_poly_fit(lut))
    g = (np.arange(64) + 0.5) / 64
    nv, r = np.meshgrid(g, g, indexing="xy")
    fit = ti.brdf_poly_eval(coeffs, torch.from_numpy(nv.astype(np.float32)),
                            torch.from_numpy(r.astype(np.float32))).numpy()
    err = np.abs(fit - lut)
    assert err.max() < 8e-3, err.max()
    assert err.mean() < 5e-4, err.mean()


PROPERTIES = {name[len("_prop_"):]: fn for name, fn in dict(globals()).items()
              if name.startswith("_prop_")}


@pytest.mark.parametrize("prop", sorted(PROPERTIES))
def test_ibl_properties_on_port(prop):
    """tests/test_ibl.py's 14 properties (mappings, convolutions, the
    environment term, the sky, SH9, the Chebyshev fit), on the port."""
    PROPERTIES[prop]()


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------

def test_sky_background_matches_jax(carried, ref_env):
    """The quarter-resolution skydome of EnvironmentMapUnitTest's first
    camera, upsampled 4x, at hdri_yaw 0 and at a turn, and the per-pixel
    view rays: the rays within 1e-6, the sky within 2e-6 relative."""
    ps = scene_load.load_scene("EnvironmentMapUnitTest", W, H)
    b, cams, lights = jax_load_scene("EnvironmentMapUnitTest", W, H)
    r = VQRendererTorch(CPU)
    r.load_scene(ps.buffers)
    for yaw in YAWS:
        tc = r.build_frame_constants(ps.buffers, ps.cameras[0], ps.lights,
                                     hdri_yaw=yaw)
        jc = VQRendererTPU().build_frame_constants(b, cams[0], lights,
                                                   hdri_yaw=yaw)
        np.testing.assert_allclose(tg.sky_directions(tc, W, H).numpy(),
                                   np.asarray(jg.sky_directions(jc, W, H)),
                                   rtol=0, atol=1e-6)
        out = tg.sky_background(tc, carried, W, H)
        assert out.shape == (H, W, 3)
        assert max_rel(out, jg.sky_background(jc, ref_env, W, H)) < 2e-6, yaw


@pytest.mark.parametrize("name", list(FRAMES))
def test_env_frame_matches_jax(frames, name):
    """render_forward with the environment on EnvironmentMapUnitTest, the
    reference's tables carried across: tri_id bitwise, every specular
    fetch on the reference's texel, ldr within LDR_TOL (measured numbers
    printed, with the frame on the port's own tables beside it)."""
    f = frames[name]
    ref, port, own = f["ref"], f["port"], f["own"]
    assert_bitwise(port["tri_id"], ref["tri_id"], "tri_id")
    covered = float((ref["tri_id"] >= 0).mean())
    diff = float(np.abs(port["ldr"].numpy() - ref["ldr"]).max())
    own_diff = float(np.abs(own["ldr"].numpy() - ref["ldr"]).max())
    print(f"\n{name}: covered {covered:.3f}, specular fetches "
          f"{len(f['mismatches'])}, texel mismatches {f['mismatches']}, max "
          f"|ldr diff| {diff:.3g} (port's own tables: {own_diff:.3g})")
    assert covered > 0.15
    assert f["mismatches"] == [0] * len(f["mismatches"])
    assert diff <= LDR_TOL, diff
    # the port's own tables differ from the reference's by bf16 roundings
    # of the load-time products (test_environment_tables_match_jax)
    assert own_diff <= 1e-2, own_diff


def test_env_frame_sky_and_layers(frames):
    """The frames really carry the environment: the background is the
    skydome, not the clear color; the transparent pass changed the
    translucent spheres' pixels; MSAA blended some edge pixels."""
    plain = frames["plain"]["port"]
    bg = plain["tri_id"] < 0
    assert bool(bg.any())
    assert float(plain["hdr"][bg].std(dim=0).max()) > 1e-3   # a gradient
    assert not torch.equal(frames["translucent"]["port"]["ldr"], plain["ldr"])
    assert not torch.equal(frames["msaa_shade"]["port"]["ldr"], plain["ldr"])


def test_envmap_unit_test_golden_on_port():
    """The envmap_unit_test golden through the port on the CPU, its
    environment maps built at the engine's default sizes (row-chunked)."""
    with threadpool_limits(limits=1):   # the LUT fit's BLAS, on a loaded host
        s = golden_scores("envmap_unit_test",
                          render_golden("envmap_unit_test", CPU))
    assert s["ok"], s


# ---------------------------------------------------------------------------
# host: the environment decode
# ---------------------------------------------------------------------------

def test_decode_environment(tmp_path):
    """Preset lookup, the procedural fallback shaped by SunPitch, SunYaw
    and Turbidity, an HDRI file found on disk and capped at 2048 wide,
    and a scene without an environment."""
    import math
    from vqengine_tpu_torch.scene.serialization import FSceneRepresentation
    dirs = scene_load.find_data_dirs()
    presets = scene_load.load_environment_presets(dirs)
    assert {"ProceduralNoon", "ProceduralOvercast", "VeniceSunset"} <= set(presets)
    rep = FSceneRepresentation()
    assert scene_load.decode_environment(rep, dirs, presets) == (None, 0.0)
    rep.env_map_preset = "ProceduralSky"           # not a preset: the default sky
    eq, cll = scene_load.decode_environment(rep, dirs, presets)
    assert_bitwise(eq, ji.procedural_sky_equirect(512, 256))
    assert cll == 0.0
    rep.env_map_preset = "ProceduralOvercast"
    eq, cll = scene_load.decode_environment(rep, dirs, presets)
    p, y = math.radians(45.0), math.radians(120.0)
    assert_bitwise(eq, ji.procedural_sky_equirect(
        512, 256, sun_dir=(math.cos(p) * math.sin(y), math.sin(p),
                           math.cos(p) * math.cos(y)),
        sun_intensity=50.0 / (8.0 / 2.5)))
    assert cll == 350.0
    wide = np.random.default_rng(5).uniform(0, 4, (32, 4096, 3)).astype(np.float32)
    write_hdr(tmp_path / "wide.hdr", wide)
    rep.env_map_preset, rep.env_map_path = "", str(tmp_path / "wide.hdr")
    eq, _ = scene_load.decode_environment(rep, dirs, presets)
    assert eq.shape == (16, 2048, 3)


def test_loaded_scene_builds_environment():
    """load_scene decodes the level's environment and VQRendererTorch
    builds the maps at load; render lights the frame with them unless
    env=None is passed."""
    s = scene_load.load_scene("HelloCube", 64, 32)
    assert s.equirect is None and not s.wants_environment
    s = scene_load.load_scene("EnvironmentMapUnitTest", 64, 32)
    assert s.wants_environment and s.equirect.shape == (256, 512, 3)
    r = VQRendererTorch(CPU)
    r.load_scene(s.buffers, equirect=s.equirect[::8, ::8])
    assert r.env is not None and r.env.equirect.dtype == torch.bfloat16
    c = r.build_frame_constants(s.buffers, s.cameras[0], s.lights)
    lit = r.render(c, 64, 32)["ldr"]
    bare = r.render(c, 64, 32, env=None)["ldr"]
    assert not torch.equal(lit, bare)


# ---------------------------------------------------------------------------
# ESM against PCF on the port (tests/test_palette_esm.py:39-70,
# tests/test_shadow.py:116)
# ---------------------------------------------------------------------------

def _occluder_and_ground():
    """tests/test_shadow.py's scene: a small quad floating above a big
    ground plane, on the port's mesh module."""
    cube = tmesh.cube().lods[0]
    ground = tmesh.grid(20.0, 20.0, 2, 2).lods[0]
    v = cube.positions.shape[0]
    pos = np.concatenate([cube.positions * [1.5, 0.1, 1.5] + [0, 3, 0],
                          ground.positions])
    idx = np.concatenate([cube.indices, ground.indices + v]).astype(np.int32)
    return (torch.from_numpy(pos.astype(np.float32)),
            torch.zeros(pos.shape[0], dtype=torch.int32),
            torch.eye(4)[None], torch.from_numpy(idx))


def test_esm_matches_hard_shadow_far_from_edges():
    """Occluder at depth 0.3 over background 0.8: the prefiltered map
    stays on the plateaus away from the edges."""
    dmap = np.full((128, 128), 0.8, np.float32)
    dmap[32:96, 32:96] = 0.3
    e = tsh.prefilter_esm(torch.from_numpy(dmap)).numpy()
    assert abs(e[64, 64] - 0.3) < 0.02
    assert abs(e[8, 8] - 0.8) < 0.02


def test_esm_visibility_behavior():
    """A receiver at the map's depth is lit, one behind it is shadowed,
    one outside the frustum gets 0 (the reference's convention)."""
    esm = tsh.prefilter_esm(torch.full((64, 64), 0.5))
    vp = torch.eye(4)
    lit = tsh.shadow_test_esm(torch.tensor([[0.0, 0.0, 0.5]]), vp, esm, 0.01)
    dark = tsh.shadow_test_esm(torch.tensor([[0.0, 0.0, 0.7]]), vp, esm, 0.01)
    out = tsh.shadow_test_esm(torch.tensor([[5.0, 0.0, 0.5]]), vp, esm, 0.01)
    assert float(lit[0]) > 0.9
    assert float(dark[0]) < 0.01
    assert float(out[0]) == 0.0


def test_pooled_esm_visibility_error_bounded():
    """The production ESM path (prefilter, pooled once) against 5x5 PCF at
    full resolution on a 512^2 directional map of the occluder over the
    ground: mean error < 0.01, lit regions < 0.005, shadowed < 0.05, as
    tests/test_shadow.py:116 bounds the reference."""
    pos, iov, world, idx = _occluder_and_ground()
    l = Light(type=ELightType.DIRECTIONAL, casts_shadows=True,
              viewport_x=16, viewport_y=16, distance_from_origin=50,
              shadow_near=0.1, shadow_far=100, depth_bias=0.003)
    vp = torch.from_numpy(l.view_projection())
    dmap = tsh.render_shadow_depth(pos, iov, world, vp, idx, 512)
    g = np.linspace(-6.0, 6.0, 49, dtype=np.float32)
    gx, gz = np.meshgrid(g, g)
    wpos = torch.from_numpy(np.stack([gx, np.zeros_like(gx), gz], axis=-1))
    ndotl = torch.ones(wpos.shape[:2])
    pcf = tsh.shadow_test_pcf(wpos, ndotl, vp, dmap, l.depth_bias,
                              slope_scaled=False).numpy()
    esm = tsh.shadow_test_esm(wpos, vp, tsh.prefilter_esm(dmap, pool=1),
                              l.depth_bias).numpy()
    err = np.abs(esm - pcf)
    assert err.mean() < 0.01, f"mean |ESM-PCF| = {err.mean():.4f}"
    lit, shadowed = pcf > 0.95, pcf < 0.05
    assert lit.any() and shadowed.any()
    assert err[lit].mean() < 0.005
    assert err[shadowed].mean() < 0.05
