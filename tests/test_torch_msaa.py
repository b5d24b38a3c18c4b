"""Parity of the port's MSAA path with the JAX package on the CPU: kernel
K1's MSAA variant (plain version), the packed records, ops/sparse.py,
ops/msaa.py's edge resolve, render_forward in the three edge-resolve
modes, and kernel K2's MSAA variant (plain version).

Each side builds its scene with its own host modules; the reference runs
op by op, its Pallas kernels in interpret mode, shared through
module-scoped fixtures at one set of shapes (192x108 frames binned at one
pair capacity, so that the reference compiles each op and its raster
kernel once): the crossing quads of tests/test_msaa_resolve.py, with
shadow-casting lights added, and HelloCube, as the goldens render it.
The quads go through the reference's own geometry_pass(msaa=True), front
end and binning included; HelloCube's reference rasterizes the port's
binning (its front end is the non-MSAA one, whose parity
tests/test_torch_raster.py, test_torch_slice.py and test_torch_shadow.py
hold; a second op-by-op compile of it would cost more than the rest of
this module). Crafted records (ops/raster_probes.py and the helpers
below) pin the roundings that no frame reaches.

To keep the module inside its time budget, the reference's raster
kernels (test_torch_slice.compiled_rasters), its ops/sparse.py and its
edge score (compiled_exact_ops) run compiled whole under jax.jit, which
leaves their outputs bit for bit as op by op; everything that rounds a
product stays op by op.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_msaa_resolve as jax_quads
from test_torch_slice import compiled_rasters, jax_load_scene
from vqengine_tpu.ops import msaa as jm
from vqengine_tpu.ops import raster as jr
from vqengine_tpu.ops import sparse as jsp
from vqengine_tpu.render import graph as jg
from vqengine_tpu.render.renderer import VQRendererTPU
from vqengine_tpu.render.scene_buffers import (
    build_scene_buffers as jax_build_scene_buffers)
from vqengine_tpu.scene import light as jax_light
from vqengine_tpu.utils import math3d as jax_m3
from vqengine_tpu_torch.engine.scene_load import load_scene
from vqengine_tpu_torch.ops import msaa as tm
from vqengine_tpu_torch.ops import raster as tr
from vqengine_tpu_torch.ops import raster_probes
from vqengine_tpu_torch.ops import sparse as tsp
from vqengine_tpu_torch.render import graph as tg
from vqengine_tpu_torch.render.renderer import (VQRendererTorch,
                                                frame_constants_numpy)
from vqengine_tpu_torch.render.scene_buffers import DrawItem, build_scene_buffers
from vqengine_tpu_torch.scene import light as port_light
from vqengine_tpu_torch.scene import mesh as meshmod
from vqengine_tpu_torch.scene.camera import Camera, FCameraParameters
from vqengine_tpu_torch.scene.material import Material
from vqengine_tpu_torch.utils import math3d as m3

torch.set_num_threads(1)

CPU = torch.device("cpu")
W, H = 192, 108           # every frame of this module, as the goldens
PAIR_CAP = 8704           # one binning capacity for both scenes
LDR_TOL = 3e-4            # the multichip bar of the reference
GBUF_TOL = 1e-6
MODES = [True, "shade", False]


# the reference's functions that count, move and compare, and round
# nothing: (module, name, static arguments)
_EXACT = [(jsp, "compact_indices", ("cap", "block")),
          (jsp, "block_count", ("block",)),
          (jsp, "adaptive_threshold", ("thresholds", "cap", "block")),
          (jsp, "gather_pixels", ()), (jsp, "scatter_pixels", ()),
          (jm, "detect_edge_score", ("z_tol",))]


@pytest.fixture(scope="module", autouse=True)
def compiled_exact_ops():
    """The reference's ops/sparse.py and its edge score compiled whole
    under jax.jit for this module, wherever the JAX package calls them:
    they count, move and compare, and round nothing, so their outputs are
    the op-by-op calls' bit for bit, at one compile per function and
    shape instead of one per operation."""
    orig = [(mod, name, getattr(mod, name)) for mod, name, _ in _EXACT]
    for mod, name, static in _EXACT:
        setattr(mod, name, jax.jit(getattr(mod, name), static_argnames=static))
    yield
    for mod, name, fn in orig:
        setattr(mod, name, fn)


def bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def assert_bitwise(out, ref, what=""):
    out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    np.testing.assert_array_equal(bits(out), bits(ref), what)


def caster_lights(light_module, m3_module) -> list:
    """The quads' lights on either package's Light: the directional light
    of tests/test_msaa_resolve.py, now casting, and a casting spot and
    point light, so that the shade-mode edge resolve gathers every kind of
    shadow visibility."""
    Light, kind = light_module.Light, light_module.ELightType
    x_axis = np.array([1.0, 0, 0], np.float32)
    return [
        Light(type=kind.DIRECTIONAL, brightness=2.5, casts_shadows=True,
              rotation=m3_module.quat_from_axis_angle(x_axis, 0.9),
              viewport_x=6, viewport_y=6, distance_from_origin=10.0),
        Light(type=kind.SPOT, brightness=40.0, casts_shadows=True,
              position=np.array([1.5, 0.5, -3.0], np.float32),
              rotation=m3_module.quat_from_axis_angle(
                  np.array([0, 1.0, 0], np.float32), -0.45),
              range=20.0, shadow_far=20.0, outer_cone_deg=40.0,
              inner_cone_deg=30.0),
        Light(type=kind.POINT, brightness=8.0, casts_shadows=True,
              position=np.array([-1.2, 0.8, -1.5], np.float32),
              range=20.0, shadow_far=20.0),
    ]


def port_crossing_quads():
    """The scene of tests/test_msaa_resolve.py on the port's own modules:
    a red quad facing the camera, pierced by a blue quad rotated 50 degrees
    about Y, its camera at this module's aspect, its lights caster_lights
    -> (DeviceScene, FrameConstants) on the CPU."""
    red = Material(name="red")
    red.diffuse = np.asarray([0.9, 0.05, 0.05], np.float32)
    blue = Material(name="blue")
    blue.diffuse = np.asarray([0.05, 0.05, 0.9], np.float32)
    q = meshmod.quad(1.6)
    origin = np.array([0, 0, 0.0], np.float32)
    items = [
        DrawItem("red", q, m3.Transform(position=origin), 0, 0),
        DrawItem("blue", q, m3.Transform(
            position=origin, rotation=m3.quat_from_axis_angle(
                np.array([0, 1, 0], np.float32), np.deg2rad(50.0))), 1, 1),
    ]
    buffers = build_scene_buffers(items, [red, blue])
    p = FCameraParameters()
    p.position = np.array([0.0, 0.0, -4.0], np.float32)
    p.fov_v_deg = 60.0
    p.near_z = 0.1
    p.far_z = 100.0
    scene = tg.upload_scene(buffers, CPU, bucketize=False)
    consts = tg.frame_constants_from_numpy(
        frame_constants_numpy(buffers, Camera(p, aspect=W / H),
                              caster_lights(port_light, m3)), CPU)
    return scene, consts


def jax_crossing_quads():
    """The same scene on the JAX package's modules (tests/test_msaa_resolve.py's
    items and camera), its camera at this module's aspect."""
    cam = jax_quads._camera()
    cam.aspect = W / H
    buffers = jax_build_scene_buffers(*jax_quads._crossing_quads())
    return (jg.upload_scene(buffers, bucketize=False),
            VQRendererTPU().build_frame_constants(
                buffers, cam, caster_lights(jax_light, jax_m3)))


def _reference_gbuffer(jscene, jc, ts, tc):
    """What the reference's geometry_pass(msaa=True) returns, from the
    port's triangle setup and binning of the same scene: the reference's
    K1-MSAA on the binned records, its G-buffer unpack and its record
    packing of the setup. -> (geometry tuple, telemetry)."""
    setup, extra = tg.geometry_setup_gbuf(ts, tc, W, H)
    pb = tr.bin_triangles(setup, W, H, extra=extra, pair_capacity=PAIR_CAP)
    with compiled_rasters():
        depth, tri_id, gbuf, cov = jr.rasterize_gbuf(_jax_binned(pb), W, H,
                                                     msaa=True)
    attrs, mask = jg._attrs_from_gbuf(jscene, jc, depth, tri_id, gbuf, W, H)
    jsetup = jr.TriangleSetup(**{f.name: jnp.asarray(getattr(setup, f.name).numpy())
                                 for f in dataclasses.fields(tr.TriangleSetup)})
    attrs.update(overflow=jnp.asarray(pb.overflow.numpy()),
                 pair_demand=jnp.asarray(pb.demand.numpy()),
                 records=jr.pack_records(jsetup, jnp.asarray(extra.numpy())))
    tel = {"raster_pairs": attrs["pair_demand"].astype(jnp.float32) / pb.pair_cap}
    return (depth, tri_id, attrs, mask, cov), tel


@contextlib.contextmanager
def _geometry_from(graph, geo, geo_tel: dict):
    """graph.geometry_pass (either package's) returns geo and reports
    geo_tel while the context lasts: the frames of a fixture take the
    G-buffer it already holds (made with the frames' own arguments, or by
    _reference_gbuffer) in place of rasterizing it again."""
    orig = graph.geometry_pass

    def cached(*args, tel=None, **kw):
        assert kw["msaa"] and kw["pair_capacity"] == PAIR_CAP
        if tel is not None:
            tel.update(geo_tel)
        return geo
    graph.geometry_pass = cached
    try:
        yield
    finally:
        graph.geometry_pass = orig


def _reference(jscene, jc, geo, geo_tel, frames: dict) -> dict:
    """The reference's resolve_secondary (at the graph's capacity) on the
    G-buffer geo, and its frames, op by op, on geo (_geometry_from)."""
    depth, tri_id, attrs, mask, cov = geo
    edge_tel = {}
    edges = jm.resolve_secondary(attrs["records"], tri_id, depth,
                                 attrs["ids"][..., 0].astype(jnp.int32), mask,
                                 cov, tg.msaa_edge_cap(W, H),
                                 telemetry=edge_tel)
    with _geometry_from(jg, geo, geo_tel):
        out = {name: jg.render_forward(jscene, jc, W, H, msaa=True,
                                       pair_capacity=PAIR_CAP, **flags)
               for name, flags in frames.items()}
    return dict(geo=geo, edges=(edges, edge_tel), frames=out)


def _port_edges(geo):
    depth, tri_id, attrs, mask, cov = geo
    tel = {}
    res = tm.resolve_secondary(attrs["records"], tri_id, depth,
                               attrs["ids"][..., 0].to(torch.int32), mask, cov,
                               tg.msaa_edge_cap(W, H), telemetry=tel)
    return res, tel


@pytest.fixture(scope="module")
def quads():
    """The crossing quads on both sides: geometry (the reference's through
    its own geometry_pass), edge resolve, and the frames of the three
    edge-resolve modes (shadows off, as tests/test_msaa_resolve.py renders
    them; test_msaa_edge_secondary_shadowed_matches_jax gives the shade
    mode shadow visibility)."""
    ts, tc = port_crossing_quads()
    jscene, jc = jax_crossing_quads()
    geo_tel = {}
    with compiled_rasters():
        ref_geo = jg.geometry_pass(jscene, jc, W, H, msaa=True,
                                   pair_capacity=PAIR_CAP, tel=geo_tel)
    ref = _reference(jscene, jc, ref_geo, geo_tel, {
        str(m): dict(enable_shadows=False, msaa_edge_resolve=m) for m in MODES})
    port_tel = {}
    geo = tg.geometry_pass(ts, tc, W, H, msaa=True, pair_capacity=PAIR_CAP,
                           tel=port_tel)
    with _geometry_from(tg, geo, port_tel):
        frames = {str(m): tg.render_forward(ts, tc, W, H, enable_shadows=False,
                                            msaa=True, msaa_edge_resolve=m,
                                            pair_capacity=PAIR_CAP)
                  for m in MODES}
    return dict(ts=ts, tc=tc, jscene=jscene, jc=jc, ref=ref, geo=geo,
                edges=_port_edges(geo), frames=frames)


@pytest.fixture(scope="module")
def cube():
    """HelloCube with MSAA (default flags otherwise) on both sides, each
    loaded by its own host modules."""
    s = load_scene("HelloCube", W, H)
    r = VQRendererTorch(CPU)
    r.load_scene(s.buffers)
    tc = r.build_frame_constants(s.buffers, s.cameras[0], s.lights)
    b, cams, lights = jax_load_scene("HelloCube", W, H)
    jscene = jg.upload_scene(b)
    jc = VQRendererTPU().build_frame_constants(b, cams[0], lights)
    ref = _reference(jscene, jc, *_reference_gbuffer(jscene, jc, r.scene, tc),
                     {"neighbor": {}})
    geo = tg.geometry_pass(r.scene, tc, W, H, msaa=True, pair_capacity=PAIR_CAP)
    return dict(r=r, tc=tc, ref=ref, geo=geo, edges=_port_edges(geo))


SCENES = ["quads", "cube"]


@pytest.mark.parametrize("scene", SCENES)
def test_msaa_gbuffer_matches_jax(request, scene):
    """K1-MSAA (plain version) through geometry_pass: depth, tri_id and the
    per-sample coverage bitwise equal to the reference's, the G-buffer
    attributes within 1e-6, the packed records and the binning's demand
    and overflow bitwise."""
    d = request.getfixturevalue(scene)
    depth, tri_id, attrs, mask, cov = d["geo"]
    r_depth, r_tri_id, r_attrs, r_mask, r_cov = d["ref"]["geo"]
    assert_bitwise(tri_id, r_tri_id, "tri_id")
    assert_bitwise(depth, r_depth, "depth")
    assert_bitwise(cov, r_cov, "coverage")
    assert_bitwise(mask, r_mask, "mask")
    assert_bitwise(attrs["records"], r_attrs["records"], "records")
    for k in ("overflow", "pair_demand"):
        assert_bitwise(attrs[k], r_attrs[k], k)
    for k in ("wnrm", "wtan", "uv", "ids", "wpos"):
        np.testing.assert_allclose(attrs[k].numpy(), np.asarray(r_attrs[k]),
                                   rtol=0, atol=GBUF_TOL, err_msg=k)
    c = cov.numpy()
    assert set(np.unique(c)) == {0.0, 1.0}
    # silhouette and edge pixels: some samples covered, not all
    assert ((c.sum(0) > 0) & (c.sum(0) < 4)).any()


@pytest.mark.parametrize("scene", SCENES)
def test_resolve_secondary_matches_jax(request, scene):
    """ops/msaa.resolve_secondary on each side's own G-buffer: the
    compacted indices, live lanes, secondary ids, sample counts and pixel
    centers equal the reference's, and so does its telemetry; so do the
    edge score and mask it starts from."""
    d = request.getfixturevalue(scene)
    (ref, r_tel), (out, tel) = d["ref"]["edges"], d["edges"]
    depth, tri_id, attrs, mask, _ = d["geo"]
    r_depth, r_tri_id, r_attrs, r_mask, _ = d["ref"]["geo"]
    obj, r_obj = attrs["ids"][..., 0].to(torch.int32), r_attrs["ids"][..., 0]
    for fn_t, fn_j in ((tm.detect_edge_score, jm.detect_edge_score),
                       (tm.detect_edges, jm.detect_edges)):
        assert_bitwise(fn_t(tri_id, depth, obj, mask),
                       fn_j(r_tri_id, r_depth, r_obj.astype(jnp.int32), r_mask),
                       fn_t.__name__)
    for name, a, b in zip(("idx", "live", "sec_id", "n_sec", "px", "py"),
                          out, ref):
        b = np.asarray(b)
        a = a.numpy().astype(b.dtype) if name == "idx" else a.numpy()
        assert_bitwise(a, b, name)
    assert sorted(tel) == sorted(r_tel) == ["msaa_edges", "msaa_edges_demand"]
    for k in tel:
        assert float(tel[k]) == float(r_tel[k]), k
    live, n_sec = out[1].numpy(), out[3].numpy()
    if scene == "quads":            # the intersection line resolves
        assert live.any()
    assert ((n_sec[live] >= 1) & (n_sec[live] <= 3)).all()


def test_resolve_secondary_pad_matches_jax(quads):
    """resolve_secondary with a one-row halo (pad=1, the input of a band
    of a larger frame: here the quads' first and last rows are the halo of
    the rows between) on each side's G-buffer: every output equals the
    reference's, and the indices are the interior's."""
    depth, tri_id, attrs, mask, cov = quads["geo"]
    r_depth, r_tri_id, r_attrs, r_mask, r_cov = quads["ref"]["geo"]
    cap = tg.msaa_edge_cap(W, H)
    tel, r_tel = {}, {}
    out = tm.resolve_secondary(attrs["records"], tri_id, depth,
                               attrs["ids"][..., 0].to(torch.int32), mask,
                               cov[:, 1:-1], cap, pad=1, telemetry=tel)
    ref = jm.resolve_secondary(r_attrs["records"], r_tri_id, r_depth,
                               r_attrs["ids"][..., 0].astype(jnp.int32), r_mask,
                               r_cov[:, 1:-1], cap, pad=1, telemetry=r_tel)
    for name, a, b in zip(("idx", "live", "sec_id", "n_sec", "px", "py"),
                          out, ref):
        b = np.asarray(b)
        a = a.numpy().astype(b.dtype) if name == "idx" else a.numpy()
        assert_bitwise(a, b, name)
    assert all(float(tel[k]) == float(r_tel[k]) for k in r_tel)
    live = out[1].numpy()
    assert live.any() and (out[5].numpy()[live] < H - 2).all()


@pytest.mark.parametrize("mode", MODES, ids=str)
def test_quads_frame_matches_jax(quads, mode):
    """render_forward(msaa=True) on the crossing quads in each edge-resolve
    mode, shadows on (the shade mode gathers the directional, spot and
    point visibility for its secondary surfaces): ldr within 3e-4 of the
    reference (the multichip bar), tri_id, depth and object ids equal, the
    same saturation keys and values."""
    ref = quads["ref"]["frames"][str(mode)]
    out = quads["frames"][str(mode)]
    ldr = out["ldr"].numpy()
    assert ldr.shape == (H, W, 3) and np.isfinite(ldr).all()
    np.testing.assert_allclose(ldr, np.asarray(ref["ldr"]), rtol=0, atol=LDR_TOL)
    for k in ("tri_id", "depth", "object_id", "overflow", "pair_demand"):
        assert_bitwise(out[k], ref[k], k)
    assert sorted(out["saturation"]) == sorted(ref["saturation"])
    for k, v in out["saturation"].items():
        assert float(v) == float(ref["saturation"][k]), k


def test_quads_edge_resolve_blends(quads):
    """The resolve changes the intersection's pixels and nothing far from
    it (tests/test_msaa_resolve.py's checks, on the port)."""
    on, off = (quads["frames"][str(m)]["ldr"].numpy() for m in (True, False))
    diff = np.abs(on - off).max(axis=-1)
    assert (diff > 0.01).any()
    blended = on[diff > 0.02]
    assert (blended[:, 0] > 0.02).any() and (blended[:, 2] > 0.02).any()
    assert np.abs(on[:, :W // 8] - off[:, :W // 8]).max() < 1e-5
    assert np.abs(on[:, -W // 8:] - off[:, -W // 8:]).max() < 1e-5


def test_msaa_edge_secondary_shadowed_matches_jax(quads):
    """The "shade" edge resolve with shadows on: _msaa_edge_secondary on
    each side's quads G-buffer, given the same seeded spot, point and
    directional visibility (the shadow pass's output, which the secondary
    surfaces gather at their pixels), and the quads' casting lights: the
    secondary weight equal, its color within 1e-6."""
    depth, tri_id, attrs, mask, cov = quads["geo"]
    r_depth, r_tri_id, r_attrs, r_mask, r_cov = quads["ref"]["geo"]
    rng = np.random.default_rng(9)
    vis = [rng.random(shape).astype(np.float32)
           for shape in ((1, H, W), (1, H, W), (H, W))]
    w, rgb = tg._msaa_edge_secondary(
        quads["ts"], quads["tc"], attrs, tri_id, depth, mask, cov,
        *(torch.from_numpy(v) for v in vis), W, H, True)
    r_w, r_rgb = jg._msaa_edge_secondary(
        quads["jscene"], quads["jc"], None, None, r_attrs, r_tri_id, r_depth,
        r_mask, r_cov, None, None, *(jnp.asarray(v) for v in vis), W, H, 0,
        None, True)
    assert_bitwise(w, r_w, "w_sec")
    np.testing.assert_allclose(rgb.numpy(), np.asarray(r_rgb), rtol=0,
                               atol=GBUF_TOL)
    # the visibility reaches the color: other values give another one
    _, rgb1 = tg._msaa_edge_secondary(
        quads["ts"], quads["tc"], attrs, tri_id, depth, mask, cov,
        *(torch.ones(v.shape) for v in vis), W, H, True)
    assert float((rgb1 - rgb).abs().max()) > 1e-3


def test_msaa_edge_secondary_ao_matches_jax(quads):
    """The "shade" edge resolve with SSAO (graph.py:1353-1356): given the
    same seeded AO map, _msaa_edge_secondary on each side's quads
    G-buffer multiplies the secondary surface's ambient term by the AO at
    its pixel: the secondary weight equal, its color within GBUF_TOL, and
    another AO map gives another color."""
    depth, tri_id, attrs, mask, cov = quads["geo"]
    r_depth, r_tri_id, r_attrs, r_mask, r_cov = quads["ref"]["geo"]
    ao = np.random.default_rng(10).uniform(0.2, 1.0, (H, W)).astype(np.float32)
    w, rgb = tg._msaa_edge_secondary(
        quads["ts"], quads["tc"], attrs, tri_id, depth, mask, cov,
        None, None, None, W, H, False, ao_map=torch.from_numpy(ao))
    r_w, r_rgb = jg._msaa_edge_secondary(
        quads["jscene"], quads["jc"], None, None, r_attrs, r_tri_id, r_depth,
        r_mask, r_cov, jnp.asarray(ao), None, None, None, None, W, H, 0,
        None, False)
    assert_bitwise(w, r_w, "w_sec")
    np.testing.assert_allclose(rgb.numpy(), np.asarray(r_rgb), rtol=0,
                               atol=GBUF_TOL)
    _, rgb1 = tg._msaa_edge_secondary(
        quads["ts"], quads["tc"], attrs, tri_id, depth, mask, cov,
        None, None, None, W, H, False)
    assert float((rgb1 - rgb).abs().max()) > 1e-4


def test_hello_cube_msaa_frame_matches_jax(cube):
    """HelloCube at 192x108 with MSAA and the default (neighbor) edge
    resolve: ldr within 3e-4 of the reference, tri_id equal."""
    ref = cube["ref"]["frames"]["neighbor"]
    out = tg.render_forward(cube["r"].scene, cube["tc"], W, H, msaa=True,
                            pair_capacity=PAIR_CAP)
    np.testing.assert_allclose(out["ldr"].numpy(), np.asarray(ref["ldr"]),
                               rtol=0, atol=LDR_TOL)
    assert_bitwise(out["tri_id"], ref["tri_id"], "tri_id")
    assert float(out["saturation"]["msaa_edges"]) == float(
        ref["saturation"]["msaa_edges"])


# ---------------------------------------------------------------------------
# ops/sparse.py on seeded masks
# ---------------------------------------------------------------------------

def _masks():
    rng = np.random.default_rng(5)
    sparse_ = rng.random((48, 64)) < 0.05
    lines = np.zeros((48, 61), bool)        # a width not a multiple of 8
    lines[::7, :] = True
    lines[:, 13] = True
    return {"sparse": sparse_, "lines": lines}


# (mask, cap, block): 4096 fits; 64 does not (demand > cap)
COMPACT_CASES = [("sparse", 64, 1), ("sparse", 4096, 8), ("lines", 4096, 8),
                 ("lines", 64, 8)]


@pytest.mark.parametrize("name,cap,block", COMPACT_CASES)
def test_compact_indices_matches_jax(name, cap, block):
    mask = _masks()[name]
    ref = jsp.compact_indices(jnp.asarray(mask), cap, block=block)
    out = tsp.compact_indices(torch.from_numpy(mask), cap, block=block)
    for what, a, b in zip(("idx", "count", "demand"), out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), what)
    assert int(out[0].shape[0]) == cap
    if cap < 4096:
        assert int(out[2]) > cap                   # truncated
    assert int(tsp.block_count(torch.from_numpy(mask), block)) == int(
        jsp.block_count(jnp.asarray(mask), block))


@pytest.mark.parametrize("cap,block", [(4096, 8), (128, 8), (16, 8), (64, 1)])
def test_adaptive_threshold_matches_jax(cap, block):
    """The ladder climbs as the capacity shrinks; the top rung (4.0) keeps
    nothing."""
    rng = np.random.default_rng(6)
    score = rng.choice([0.0, 1.0, 2.0, 3.0, 4.0], size=(40, 64),
                       p=[0.6, 0.2, 0.1, 0.06, 0.04]).astype(np.float32)
    thr, dem = jsp.adaptive_threshold(jnp.asarray(score), tm.EDGE_THRS, cap,
                                      block=block)
    t2, d2 = tsp.adaptive_threshold(torch.from_numpy(score), tm.EDGE_THRS, cap,
                                    block=block)
    assert float(t2) == float(thr) and int(d2) == int(dem)
    assert t2.dtype == torch.float32


def test_gather_scatter_match_jax():
    """Dead lanes (past count) hold index 0 and must not clobber pixel 0."""
    mask = np.zeros((8, 16), bool)
    mask[3, 5] = mask[6, 15] = True
    idx, count, _ = tsp.compact_indices(torch.from_numpy(mask), 8)
    ridx, rcount, _ = jsp.compact_indices(jnp.asarray(mask), 8)
    img = np.arange(8 * 16 * 3, dtype=np.float32).reshape(8, 16, 3)
    np.testing.assert_array_equal(
        tsp.gather_pixels(torch.from_numpy(img), idx).numpy(),
        np.asarray(jsp.gather_pixels(jnp.asarray(img), ridx)))
    vals = np.full((8, 3), 7.0, np.float32)
    live = torch.arange(8) < count
    out = tsp.scatter_pixels(torch.zeros(8, 16, 3), idx,
                             torch.from_numpy(vals), live).numpy()
    ref = jsp.scatter_pixels(jnp.zeros((8, 16, 3)), ridx, jnp.asarray(vals),
                             jnp.arange(8) < rcount)
    np.testing.assert_array_equal(out, np.asarray(ref))
    assert (out[0, 0] == 0).all() and (out[3, 5] == 7).all()


def test_msaa_constants_match_jax():
    assert tr.MSAA4_OFFSETS == jr.MSAA4_OFFSETS
    assert (tm.EDGE_Z_TOL, tm.NEIGHBOR_OFFSETS, tm.EDGE_THRS) == (
        jm.EDGE_Z_TOL, jm.NEIGHBOR_OFFSETS, jm.EDGE_THRS)
    assert tg.MSAA_EDGE_CAP_FRAC == jg.MSAA_EDGE_CAP_FRAC


# ---------------------------------------------------------------------------
# the raster kernels' plain versions on crafted records
# ---------------------------------------------------------------------------

def _crafted(rows: int, tiles_x: int, tiles_y: int, cap: int, seed: int):
    """Binned records, `cap` rows of `rows` floats: per tile one group
    whose first record covers part of the tile (a random edge 0 crossing
    it, two constant edges, and a random depth plane through z = 0.003 at
    the tile origin, so that the tile-local plane constant is small and
    shows every rounding of the fold ew + ex*x0 + ey*y0 where the tile
    origin makes the products inexact); killed records elsewhere."""
    rng = np.random.default_rng(seed)
    nt = tiles_x * tiles_y
    killed = tr.killed_record(rows, CPU).numpy()
    pairs = np.tile(killed, (cap, 1))
    for t in range(nt):
        x0, y0 = (t % tiles_x) * tr.TILE_W, (t // tiles_x) * tr.TILE_H
        a, b = (rng.uniform(0.5, 2, 2) * 1e-2 * rng.choice([-1, 1], 2)
                ).astype(np.float32)
        ea, eb = (rng.uniform(0.5, 2, 2) * rng.choice([-1, 1], 2)).astype(np.float32)
        rec = np.zeros(rows, np.float32)
        rec[0:3] = [ea, eb, -(ea * (x0 + 64) + eb * (y0 + 8)) + rng.uniform(-8, 8)]
        rec[5] = rec[8] = 1.0
        rec[9:12] = [a, b, -(a * x0 + b * y0) + 0.003]
        rec[12] = t
        pairs[t * tr.GROUP] = rec
    gpairs = np.tile(killed, (tr.GLOBAL_CAP, 1))
    i32 = np.int32
    return tr.BinnedTriangles(
        pairs=torch.from_numpy(pairs),
        starts=torch.from_numpy(np.arange(nt + 1, dtype=i32) * tr.GROUP),
        rstarts=torch.from_numpy(np.full(tiles_y + 1, nt * tr.GROUP, i32)),
        gpairs=torch.from_numpy(gpairs),
        gmeta=torch.from_numpy(np.array([0, tiles_x], i32)),
        overflow=torch.zeros(3, dtype=torch.int32),
        demand=torch.tensor(nt, dtype=torch.int32), tiles_x=tiles_x,
        tiles_y=tiles_y, pair_cap=cap)


def _crafted_k1_msaa(binned: jr.BinnedTriangles):
    """The reference's K1-MSAA at the 4 x 4 tiles of the crafted inputs
    (compiled once for both tests that use it)."""
    with compiled_rasters():
        return jr.rasterize_gbuf(binned, raster_probes.WIDTH,
                                 raster_probes.HEIGHT, msaa=True)


def test_rasterize_gbuf_crafted_matches_jax():
    """K1-MSAA's plain version on crafted tiles 4 x 4: depth, tri_id,
    G-buffer and coverage bitwise (the fold's products are inexact from
    x0 = 384 and y0 = 48)."""
    w, h = 4 * tr.TILE_W, 4 * tr.TILE_H
    pb = _crafted(tr.GBUF_ROWS, 4, 4, 16 * tr.GROUP, seed=2)
    ref = _crafted_k1_msaa(_jax_binned(pb))
    out = tr.rasterize_gbuf(pb, w, h, msaa=True)
    for name, a, b in zip(("depth", "tri_id", "gbuf", "coverage"), out, ref):
        assert_bitwise(a, b, name)
    assert 0.05 < float((out[1] >= 0).float().mean()) < 0.8


def test_rasterize_gbuf_msaa_probe_matches_jax():
    """K1-MSAA's plain version on ops/raster_probes.py's records: per-sample
    thresholds whose two roundings decide the sample, for the coverage bits
    and for the depth key's test, on every sample and edge; a center-covered
    record against a nearer sample-only one; two sample-only records; a
    center-covered record at z = 1; records past the counts. Depth, tri_id,
    G-buffer and coverage bitwise equal to the reference's (which a plain
    version with either table of raster.MSAA_COVERAGE_FUSED /
    MSAA_KEY_FUSED swapped, or with sample_offset's rounding, fails)."""
    pb, counts = raster_probes.msaa_probe()
    out = tr.rasterize_gbuf(pb, raster_probes.WIDTH, raster_probes.HEIGHT,
                            msaa=True)
    ref = _crafted_k1_msaa(_jax_binned(pb))
    for name, a, b in zip(("depth", "tri_id", "gbuf", "coverage"), out, ref):
        assert_bitwise(a, b, name)
    depth, tri_id, _, cov = (o.numpy() for o in out)
    n = cov.sum(axis=0)
    # the threshold pixels cover one sample or none; the z = 1 quirk
    assert ((n == 1) & (tri_id >= 0)).sum() >= counts["thresholds"] // 4
    assert ((n == 0) & (tri_id < 0)).sum() > 0
    assert ((depth == 0) & (tri_id >= 0)).sum() == counts["z1"]
    # the uncounted global-tier record (id pairs.shape[0]) covers nothing
    assert tri_id.max() < pb.pairs.shape[0] and (n == 0).mean() > 0.9


def _with_offset_records(pb: tr.BinnedTriangles, seed: int, width: int,
                         height: int):
    """pb with its global tier (streamed first by every tile) filled with
    GLOBAL_CAP one-pixel records that make each own pixel's per-sample
    depth show how the sample offset e_zx*dx + e_zy*dy rounds. Record
    (x, y) covers column x from row y down (edges x >= x + 0.1,
    x <= x + 0.9, y >= y + 0.1); its depth is 3e-4 at its pixel center
    and rises by e_zy in [1, 2] per row below (so it wins only near its
    pixel); its slopes cancel in two samples' offsets (e_zx ~ e_zy / 3
    in samples 1 and 2, e_zx ~ -3 e_zy in samples 0 and 3, on alternate
    columns), so that those samples' depths are of the order of 1e-4 and
    carry the offset's rounding."""
    rng = np.random.default_rng(seed)
    n = tr.GLOBAL_CAP
    pix = rng.choice(width * height, n, replace=False)
    x, y = (pix % width).astype(np.float32), (pix // width).astype(np.float32)
    ey = rng.uniform(1.0, 2.0, n).astype(np.float32)
    ratio = np.where(pix % 2 == 1, 1 / 3, -3.0)
    ex = (ey * ratio * (1 + rng.uniform(-1e-3, 1e-3, n))).astype(np.float32)
    rec = np.zeros((n, tr.PAIR_ROWS), np.float32)
    one, zero = np.ones(n), np.zeros(n)
    rec[:, 0:9] = np.stack([one, zero, -(x + 0.1), -one, zero, x + 0.9,
                            zero, one, -(y + 0.1)], axis=1)
    rec[:, 9] = ex
    rec[:, 10] = ey
    rec[:, 11] = 3e-4 - ex * (x + 0.5) - ey * (y + 0.5)
    rec[:, 12] = 100_000 + np.arange(n)
    return dataclasses.replace(pb, gpairs=torch.from_numpy(rec),
                               gmeta=torch.tensor([n, pb.tiles_x],
                                                  dtype=torch.int32))


def _jax_binned(pb: tr.BinnedTriangles) -> jr.BinnedTriangles:
    """The port's binning in the reference's layout ([NG, R, 128])."""
    rows = pb.pairs.shape[1]

    def blocks(a):
        return jnp.asarray(a.numpy().reshape(-1, tr.GROUP, rows).transpose(0, 2, 1))
    return jr.BinnedTriangles(
        pairs=blocks(pb.pairs), starts=jnp.asarray(pb.starts.numpy()),
        rpairs=blocks(pb.pairs), rstarts=jnp.asarray(pb.rstarts.numpy()),
        gpairs=blocks(pb.gpairs), gmeta=jnp.asarray(pb.gmeta.numpy()),
        overflow=jnp.asarray(pb.overflow.numpy()),
        demand=jnp.asarray(pb.demand.numpy()), tiles_x=pb.tiles_x,
        tiles_y=pb.tiles_y, pair_cap=pb.pair_cap)


def test_rasterize_msaa4_matches_jax(quads):
    """K2-msaa4's plain version against the reference kernel on the same
    binned input, per-sample depth and tri_id bitwise: the crossing quads'
    visibility records (the port's own setup and binning at 16 rows) in a
    128x48 frame, with one-pixel records in the global tier that pin how
    the reference rounds each sample's offset (_with_offset_records;
    raster.sample_offset)."""
    w, h = tr.TILE_W, 3 * tr.TILE_H
    setup, _ = tg.geometry_setup_gbuf(quads["ts"], quads["tc"], w, h)
    pb = _with_offset_records(
        tr.bin_triangles(setup, w, h, pair_capacity=1024), 1, w, h)
    assert pb.pairs.shape == (1024, tr.PAIR_ROWS)
    d, i = tr.rasterize(pb, w, h, msaa=True)
    with compiled_rasters():
        rd, ri = jr.rasterize(_jax_binned(pb), w, h, msaa=True)
    assert tuple(d.shape) == (4, h, w)
    assert_bitwise(d, rd, "depth")
    assert_bitwise(i, ri, "tri_id")
    i = i.numpy()
    assert ((i >= 0) & (i < 100_000)).any() and (i >= 100_000).any()
    # the samples differ from each other along the quads' edges
    assert (i != i[:1]).any()
