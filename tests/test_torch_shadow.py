"""Parity of the port's shadow path with the JAX package on the CPU: kernel
K2's plain version, every function of ops/shadow.py, render_shadow_maps,
shadow_pass and a whole shadowed Sponza frame.

JAX runs op by op, its Pallas kernel in interpret mode. The reference
maps are built view by view, op by op (the order of graph.py:740-769):
the JAX package's render_shadow_maps runs lax.scan, which compiles its
body, and XLA's CPU backend then contracts multiply-adds into FMAs and
moves the depth it rasterizes (ROADMAP.md, queue 3).
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_slice import compiled_rasters, jax_load_scene
from vqengine_tpu.ops import raster as jr
from vqengine_tpu.ops import shadow as js
from vqengine_tpu.render import graph as jg
from vqengine_tpu.render.renderer import VQRendererTPU
from vqengine_tpu_torch.engine.scene_load import load_scene
from vqengine_tpu_torch.ops import raster as tr
from vqengine_tpu_torch.ops import shadow as ts
from vqengine_tpu_torch.render import graph as tg
from vqengine_tpu_torch.render.renderer import (VQRendererTorch,
                                                shadow_maps_from_numpy)

torch.set_num_threads(1)

CPU = torch.device("cpu")
W, H = 126, 66          # neither side a multiple of 4: up() pads
S = 64                  # every shadow view of these tests
DIMS = (S, S, S)
VIEWS = ["spot", "point+X", "point-X", "point+Y", "point-Y", "point+Z",
         "point-Z", "dir"]


def bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def assert_bitwise(out, ref, what=""):
    out = out.float().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref)
    if ref.dtype.name == "bfloat16":
        ref = ref.astype(np.float32)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    np.testing.assert_array_equal(bits(out), bits(ref), what)


@pytest.fixture(scope="module")
def sponza():
    """Sponza on both sides, each loaded by its own host modules: the
    port's (renderer, consts) and the JAX package's (scene, consts)."""
    ps = load_scene("Sponza", W, H)
    r = VQRendererTorch(CPU)
    r.load_scene(ps.buffers)
    tc = r.build_frame_constants(ps.buffers, ps.cameras[0], ps.lights)
    b, cams, lights = jax_load_scene("Sponza", W, H)
    jscene = jg.upload_scene(b)
    jc = VQRendererTPU().build_frame_constants(b, cams[0], lights)
    assert (jc.spot_casters.shape[0], jc.point_casters.shape[0],
            jc.dir_vp.shape[0]) == (1, 1, 1)
    return r, tc, jscene, jc


def _view_vps(c):
    """The 8 caster views of Sponza in the order of VIEWS."""
    return ([c.spot_caster_vps[0]] + [c.point_caster_vps[0, f] for f in range(6)]
            + [c.dir_vp[0]])


@pytest.fixture(scope="module")
def ref_views(sponza):
    """The reference's 8 views of Sponza at S x S, op by op (its kernel
    compiled whole: compiled_rasters): the body of
    shadow.render_shadow_depth, keeping tri_id and the binning counters
    too -> [(depth, tri_id, overflow, demand)]."""
    _, _, jscene, jc = sponza
    out = []
    for vp in _view_vps(jc):
        wvp = jnp.einsum("ij,njk->nik", vp, jc.world)
        clip = jr.transform_clip_instanced(jscene.positions,
                                           jscene.item_of_vertex, wvp)
        setup = jr.setup_triangles(clip, jscene.indices, S, S)
        binned = jr.bin_triangles(setup, S, S)
        with compiled_rasters():
            depth, tri_id = jr.rasterize(binned, S, S)
        out.append(tuple(np.asarray(a) for a in
                         (depth, tri_id, binned.overflow, binned.demand)))
    return out


@pytest.fixture(scope="module")
def ref_maps(sponza, ref_views):
    """The reference's shadow-map dicts {"esm": ..., "pcf": ...} built
    from the views as graph.render_shadow_maps builds them."""
    _, _, _, jc = sponza
    d = [v[0] for v in ref_views]
    nf = np.asarray(jc.point_caster_range)[0]
    faces = np.stack([np.asarray(js.ndc_depth_to_radial(jnp.asarray(f), nf[0], nf[1]))
                      for f in d[1:7]]).reshape(1, 6, S, S)
    pcf = {"spot": np.stack(d[:1]), "point": faces, "dir": d[7]}
    esm = {"spot": js.prefilter_esm(jnp.asarray(pcf["spot"]), pool=1),
           "point": js.prefilter_esm(jnp.asarray(faces), pool=2),
           "dir": js.prefilter_esm(jnp.asarray(pcf["dir"]), pool=1)}
    esm = {k: np.asarray(v.astype(jnp.bfloat16)) for k, v in esm.items()}
    return {"esm": esm, "pcf": pcf}


# ---------------------------------------------------------------------------
# kernel K2 (plain version) on Sponza's caster views
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("view", ["spot", "point+X", "dir"])
def test_rasterize_matches_jax(sponza, ref_views, view):
    """Setup, binning at the default pair capacity and the plain K2 on
    three Sponza caster views at 64^2: depth, tri_id, overflow and demand
    bitwise equal to the reference's."""
    r, tc, _, _ = sponza
    k = VIEWS.index(view)
    vp = _view_vps(tc)[k]
    scene = r.scene
    binned = ts.bin_shadow_view(scene.positions, scene.item_of_vertex,
                                tc.world, vp, scene.indices, S)
    assert binned.pairs.shape[1] == tr.PAIR_ROWS
    assert binned.pair_cap == tr.cdiv(tr.default_pair_cap(
        scene.indices.shape[0]), tr.GROUP) * tr.GROUP
    depth, tri_id = tr.rasterize(binned, S, S)
    d_ref, id_ref, ov_ref, dem_ref = ref_views[k]
    assert float((tri_id >= 0).float().mean()) > 0.2      # the view sees geometry
    assert_bitwise(depth, d_ref, "depth")
    assert_bitwise(tri_id.numpy(), id_ref, "tri_id")
    np.testing.assert_array_equal(binned.overflow.numpy(), ov_ref)
    assert int(binned.demand) == int(dem_ref)


# ---------------------------------------------------------------------------
# ops/shadow.py function by function, on seeded inputs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def seeded(sponza, ref_maps):
    """Receivers around Sponza's geometry at the frame's size (so that the
    reference compiles each op once for this module) and random normals,
    from one seed; the maps and light matrices are Sponza's own (the
    reference's maps)."""
    _, _, jscene, jc = sponza
    rng = np.random.default_rng(11)
    # world positions of random vertices, jittered
    v = rng.integers(0, jscene.positions.shape[0], H * W)
    world = np.asarray(jc.world)[np.asarray(jscene.item_of_vertex)[v]]
    pos = np.asarray(jscene.positions)[v]
    wpos = (np.einsum("nij,nj->ni", world[:, :3, :3], pos) + world[:, :3, 3]
            + rng.normal(0, 0.05, (H * W, 3))).astype(np.float32).reshape(H, W, 3)
    nrm = rng.normal(size=(H, W, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    c = {f.name: np.asarray(getattr(jc, f.name)) for f in dataclasses.fields(jc)}
    return dict(wpos=wpos, nrm=nrm, c=c, pcf=ref_maps["pcf"], esm=ref_maps["esm"])


def _both(fn_j, fn_t, *args):
    """Run the JAX and the port function on the same numpy arguments."""
    args = [np.asarray(a) if isinstance(a, np.generic) else a for a in args]
    ja = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
    ta = []
    for a in args:
        if isinstance(a, np.ndarray):
            ta.append(torch.from_numpy(a.view(np.uint16).view(np.int16).copy())
                      .view(torch.bfloat16) if a.dtype.name == "bfloat16"
                      else torch.from_numpy(a.copy()))
        else:
            ta.append(a)
    return fn_j(*ja), fn_t(*ta)


def _cases(d):
    """The functions at the shapes shadow_pass gives them on this frame:
    PCF at full resolution, the directional ESM test at half and the
    batched ESM tests at quarter resolution."""
    c, wpos, nrm, pcf, esm = d["c"], d["wpos"], d["nrm"], d["pcf"], d["esm"]
    wpos_h = np.asarray(jg.pool2(jnp.asarray(wpos)))
    wpos_q = np.asarray(jg.pool2(jnp.asarray(wpos_h)))
    vp, dvp = c["spot_caster_vps"][0], c["dir_vp"][0]
    lpos = c["point_casters"][0, 0:3]
    far, bias = c["point_casters"][0, 9], c["point_casters"][0, 8]
    nl = np.clip((nrm * -c["directional"][0:3]).sum(-1), 0, 1).astype(np.float32)
    near_far = c["point_caster_range"][0]
    uv = (np.random.default_rng(3).uniform(-0.2, 1.2, (H, W, 2))
          .astype(np.float32))
    dirs = nrm.copy()
    dirs[:3, :, 0] = 0.0                    # sign(0) and ties of the axes
    dirs[3:6, :, 1] = dirs[3:6, :, 2] = dirs[3:6, :, 0]
    return {
        # name: (jax fn, port fn, args, max |diff| allowed; 0 = bitwise)
        "ndc_depth_to_radial": (js.ndc_depth_to_radial, ts.ndc_depth_to_radial,
                                (pcf["point"][0, 0], near_far[0], near_far[1]), 0),
        "project_to_light": (lambda *a: jnp.concatenate(
            [js._project_to_light(*a)[0], js._project_to_light(*a)[1][..., None],
             js._project_to_light(*a)[2][..., None]], -1),
            lambda *a: torch.cat([ts._project_to_light(*a)[0],
                                  ts._project_to_light(*a)[1][..., None],
                                  ts._project_to_light(*a)[2][..., None]], -1),
            (wpos, vp), 0),
        "fetch_nearest_f32": (js._fetch_nearest, ts._fetch_nearest,
                              (pcf["point"][0, 1], uv), 0),
        "fetch_nearest_bf16": (js._fetch_nearest, ts._fetch_nearest,
                               (esm["dir"], uv), 0),
        "shadow_test_pcf_slope": (
            functools.partial(js.shadow_test_pcf, slope_scaled=True),
            functools.partial(ts.shadow_test_pcf, slope_scaled=True),
            (wpos, nl, vp, pcf["spot"][0], c["spot_casters"][0, 11]), 0),
        "shadow_test_pcf_flat": (
            functools.partial(js.shadow_test_pcf, slope_scaled=False),
            functools.partial(ts.shadow_test_pcf, slope_scaled=False),
            (wpos, nl, dvp, pcf["dir"], c["directional"][7]), 0),
        "cube_face_uv": (lambda v: jnp.concatenate(
            [js._cube_face_uv(v)[0][..., None].astype(jnp.float32),
             js._cube_face_uv(v)[1]], -1),
            lambda v: torch.cat([ts._cube_face_uv(v)[0][..., None].float(),
                                 ts._cube_face_uv(v)[1]], -1),
            (dirs,), 0),
        "box_blur_clamped": (js._box_blur_clamped, ts._box_blur_clamped,
                             (pcf["point"][0], 2), 0),
        "pool2_map": (js.pool2_map, ts.pool2_map, (pcf["point"][0], 2), 0),
        "pool2": (jg.pool2, tg.pool2, (wpos,), 0),
        "pool2_min": (functools.partial(jg.pool2, reduce="min"),
                      functools.partial(tg.pool2, reduce="min"), (wpos,), 0),
        # exp and log differ by an f32 ulp between XLA and PyTorch on a
        # few inputs (measured on random maps: 12 of 3072 values, at most
        # 5.96e-8)
        "prefilter_esm": (functools.partial(js.prefilter_esm, pool=2),
                          functools.partial(ts.prefilter_esm, pool=2),
                          (pcf["point"],), 1.2e-7),
        # the tests' exp(160 (d_map - d)) differs by an ulp or two:
        # visibility in [0, 1], so 3e-7 absolute
        "shadow_test_esm": (js.shadow_test_esm, ts.shadow_test_esm,
                            (wpos_h, dvp, esm["dir"], c["directional"][7]), 3e-7),
        "shadow_test_esm_batch": (
            js.shadow_test_esm_batch, ts.shadow_test_esm_batch,
            (wpos_q, c["spot_caster_vps"], esm["spot"], c["spot_casters"][:, 11]),
            3e-7),
        "omni_shadow_test_esm_batch": (
            js.omni_shadow_test_esm_batch, ts.omni_shadow_test_esm_batch,
            (wpos_q, c["point_casters"][:, 0:3], esm["point"],
             c["point_casters"][:, 9], c["point_casters"][:, 8]), 3e-7),
        "omni_shadow_test_esm": (
            js.omni_shadow_test_esm, ts.omni_shadow_test_esm,
            (wpos_q, lpos, esm["point"][0], far, bias), 3e-7),
        "omni_shadow_test_pcf": (
            js.omni_shadow_test_pcf, ts.omni_shadow_test_pcf,
            (wpos, lpos, pcf["point"][0], far, bias, c["camera_pos"]), 0),
    }


CASES = ["ndc_depth_to_radial", "project_to_light", "fetch_nearest_f32",
         "fetch_nearest_bf16", "shadow_test_pcf_slope", "shadow_test_pcf_flat",
         "cube_face_uv", "box_blur_clamped", "pool2_map", "pool2", "pool2_min",
         "prefilter_esm", "shadow_test_esm", "shadow_test_esm_batch",
         "omni_shadow_test_esm_batch", "omni_shadow_test_esm",
         "omni_shadow_test_pcf"]


@pytest.mark.parametrize("name", CASES)
def test_shadow_op_matches_jax(seeded, name):
    """Each function of ops/shadow.py (and graph.pool2) against its JAX
    counterpart on the same seeded numpy inputs: bitwise, except where
    exp and log enter (tolerance beside each case)."""
    fj, ft, args, tol = _cases(seeded)[name]
    ref, out = _both(fj, ft, *args)
    ref = np.asarray(ref, np.float32)
    out = out.float().numpy()
    assert out.shape == ref.shape
    if tol == 0:
        np.testing.assert_array_equal(bits(out), bits(ref))
    else:
        np.testing.assert_allclose(out, ref, rtol=0, atol=tol)
    assert np.unique(ref).size > 1                      # not a constant


def test_shadow_constants():
    assert (ts.SPOT_SHADOW_DIM, ts.POINT_SHADOW_DIM, ts.DIRECTIONAL_SHADOW_DIM
            ) == (js.SPOT_SHADOW_DIM, js.POINT_SHADOW_DIM, js.DIRECTIONAL_SHADOW_DIM)
    assert ts.ESM_TEST_SHARPNESS == js.ESM_TEST_SHARPNESS
    assert_bitwise(ts.OMNI_TAPS, js.OMNI_TAPS)


# ---------------------------------------------------------------------------
# render_shadow_maps, shadow_pass and the frame
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_maps(sponza):
    """The port's render_shadow_maps of Sponza at 64^2, both filters."""
    r, tc, _, _ = sponza
    return {f: tg.render_shadow_maps(r.scene, tc, DIMS, f) for f in ("esm", "pcf")}


@pytest.mark.parametrize("filter_mode", ["esm", "pcf"])
def test_render_shadow_maps_matches_reference(port_maps, ref_maps, filter_mode):
    """All 8 Sponza views at 64^2 through the port's render_shadow_maps
    against the reference maps built view by view: bitwise equal in both
    filters (PCF: the raw depth and radial maps; ESM: the bf16 maps after
    blur, pool, exp and log; measured bitwise on all texels here, though
    exp and log may differ by an f32 ulp, which the bf16 cast absorbs)."""
    maps = port_maps[filter_mode]
    ref = ref_maps[filter_mode]
    assert sorted(maps) == sorted(ref)
    if filter_mode == "esm":
        assert {k: v.dtype for k, v in maps.items()} == dict.fromkeys(
            ref, torch.bfloat16)
    for k in ref:
        assert_bitwise(maps[k], ref[k], k)


@pytest.mark.parametrize("filter_mode", ["esm", "pcf"])
def test_shadow_pass_matches_jax(sponza, ref_maps, seeded, filter_mode):
    """shadow_pass on the same maps (the reference's, carried into the
    port by shadow_maps_from_numpy) and the same seeded receivers at 66x126
    (ESM tests at 33x63 and 16x31, then padded back): PCF bitwise; ESM
    within 3e-7 (exp)."""
    _, tc, jscene, jc = sponza
    wpos, nrm = seeded["wpos"], seeded["nrm"]
    ref = jg.shadow_pass(jscene, jc, jnp.asarray(wpos), jnp.asarray(nrm), DIMS,
                         filter_mode, shadow_maps={
                             k: jnp.asarray(v) for k, v in ref_maps[filter_mode].items()})
    out = tg.shadow_pass(None, tc, torch.from_numpy(wpos), torch.from_numpy(nrm),
                         DIMS, filter_mode,
                         shadow_maps=shadow_maps_from_numpy(ref_maps[filter_mode], CPU))
    for name, a, b in zip(("spot", "point", "dir"), out, ref):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape == ((H, W) if name == "dir"
                                             else (1, H, W)), name
        if filter_mode == "pcf":
            np.testing.assert_array_equal(bits(a.numpy()), bits(b), name)
        else:
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=3e-7, err_msg=name)


def test_sponza_frame_matches_jax(sponza, port_maps, ref_maps):
    """A whole Sponza frame at 126x66 with the default flags (shadows on,
    ESM), shadow_dims 64, each side on its own maps (the port's from its
    render_shadow_maps, as a frame renders them; the reference's built op
    by op), the reference frame run op by op (its raster kernel compiled
    whole: compiled_rasters). tri_id agrees on >= 99.9% of pixels (all,
    measured) and ldr lies within 3e-4 where it agrees, the multichip bar
    of the reference (tests/test_multichip.py:73)."""
    r, tc, jscene, jc = sponza
    out = r.render(tc, W, H, shadow_dims=DIMS, shadow_maps=port_maps["esm"])
    with compiled_rasters():
        ref = jg.render_forward(jscene, jc, W, H, shadow_dims=DIMS,
                                shadow_maps={k: jnp.asarray(v)
                                             for k, v in ref_maps["esm"].items()})
    ldr = out["ldr"].numpy()
    assert ldr.shape == (H, W, 3) and np.isfinite(ldr).all()
    same = out["tri_id"].numpy() == np.asarray(ref["tri_id"])
    assert same.mean() >= 0.999
    np.testing.assert_allclose(ldr[same], np.asarray(ref["ldr"])[same],
                               rtol=0, atol=3e-4)
    unshadowed = r.render(tc, W, H, enable_shadows=False)["ldr"].numpy()
    assert np.abs(ldr - unshadowed).max() > 0.05        # the shadows show
