"""Parity of the port's screen-band functions (the multi-GPU slice,
vqengine_tpu_torch/parallel/multichip.py) with the JAX package, in one
process on the CPU: each band argument on the first band, an interior band
and the last band of a frame, against the reference's function run op by
op on the same seeded inputs: raster.setup_triangles' full_height and
y_offset, graph.world_pos_from_depth and _attrs_from_gbuf, the sky's
quarter rows and _axis_up4's prev/nxt, SSAO's y_offset and full_height,
the denoiser's reprojection into the gathered history and its row slice,
the mip jitter's y_offset; the MSAA edge resolves with a one-row halo and
the alpha-mask peel on a band, which the port places at the frame's rows
(against the reference's whole frame's rows); the band renderer's own
raster of the frame's rows (raster.rasterize_gbuf_band) against the whole
frame's, bitwise; then
_halo_exchange (pad 1 and 8, and a band axis of one) against the
reference's under a shard_map on 4 of conftest's 8 virtual devices, the
port's ranks played by threads; the frame-wide MSAA edge threshold; and
shard_history and gather_frames round trips.

The crossing quads of tests/test_torch_msaa.py at its 192x108 frame give
the G-buffers: three bands of 36 rows (a multiple of 4, as the sharded
renderer asks). The frames rendered by spawned ranks are
tests/test_torch_multigpu_frames.py's.
"""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from test_torch_msaa import (PAIR_CAP, W, H, _jax_binned, jax_crossing_quads,
                             port_crossing_quads)
from test_torch_slice import compiled_rasters
from test_torch_transparency import (jax_scene, material_alpha_of_rows,
                                     port_scene)
from test_torch_transparency import H as TH
from test_torch_transparency import W as TW
from vqengine_tpu.ops import msaa as jm
from vqengine_tpu.ops import raster as jr
from vqengine_tpu.ops import sparse as jsp
from vqengine_tpu.ops import ssao as jssao
from vqengine_tpu.ops import ssr as jssr
from vqengine_tpu.ops import texture as jt
from vqengine_tpu.parallel import multichip as jmc
from vqengine_tpu.render import graph as jg
from vqengine_tpu_torch.ops import raster as tr
from vqengine_tpu_torch.ops import ssao as tssao
from vqengine_tpu_torch.ops import ssr as tssr
from vqengine_tpu_torch.ops import texture as tt
from vqengine_tpu_torch.parallel import multichip as tmc
from vqengine_tpu_torch.render import graph as tg

torch.set_num_threads(1)

CPU = torch.device("cpu")
SP = 3
BH = H // SP                   # 36 rows
BANDS = [0, 1, 2]
GBUF_TOL = 1e-6
HDR_TOL = 1e-6
# the reference's compiled-whole ops (they count, move and compare, and
# round nothing: test_torch_msaa._EXACT)
_EXACT = [(jsp, "compact_indices", ("cap", "block")),
          (jsp, "block_count", ("block",)),
          (jsp, "adaptive_threshold", ("thresholds", "cap", "block")),
          (jsp, "gather_pixels", ()), (jsp, "scatter_pixels", ()),
          (jm, "detect_edge_score", ("z_tol",))]


@pytest.fixture(scope="module", autouse=True)
def compiled_exact_ops():
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


def t_(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def halo_rows(x: np.ndarray, y0: int, rows: int, pad: int) -> np.ndarray:
    """Rows [y0 - pad, y0 + rows + pad) of a frame x, edge-clamped at its
    borders: what _halo_exchange hands a band."""
    idx = np.clip(np.arange(y0 - pad, y0 + rows + pad), 0, x.shape[0] - 1)
    return x[idx]


# ---------------------------------------------------------------------------
# the front end and the G-buffer unpack
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("band", BANDS)
def test_setup_triangles_band_matches_jax(band):
    """setup_triangles with full_height and y_offset on seeded clip corners
    (some behind the near plane): every field bitwise."""
    rng = np.random.default_rng(band)
    clip = rng.uniform(-2, 2, (700, 3, 4)).astype(np.float32)
    clip[..., 3] = rng.uniform(-0.5, 5, (700, 3)).astype(np.float32)
    out = tr.setup_triangles(t_(clip), W, BH, full_height=H, y_offset=band * BH)
    ref = jr.setup_triangles(jnp.asarray(clip), None, W, BH, full_height=H,
                             y_offset=band * BH)
    for f in ("edges9", "zc", "vert_scale", "valid", "tile_lo", "tile_hi"):
        assert_bitwise(getattr(out, f), getattr(ref, f), f)
    assert bool(out.valid.any())


@pytest.fixture(scope="module")
def quads():
    """The crossing quads on both sides and the port's full-frame MSAA
    G-buffer (the reference's equal to it: test_torch_msaa)."""
    ts, tc = port_crossing_quads()
    jscene, jc = jax_crossing_quads()
    geo = tg.geometry_pass(ts, tc, W, H, msaa=True, pair_capacity=PAIR_CAP)
    return dict(ts=ts, tc=tc, jscene=jscene, jc=jc, geo=geo)


@pytest.mark.parametrize("band", BANDS)
def test_world_pos_and_attrs_band_match_jax(quads, band):
    """world_pos_from_depth and _attrs_from_gbuf on a band of the quads'
    G-buffer with full_height and y_offset: wpos and the unpacked
    attributes bitwise."""
    depth, tri_id, attrs, mask, cov = quads["geo"]
    rng = np.random.default_rng(20 + band)
    rows = slice(band * BH, (band + 1) * BH)
    d = depth[rows].numpy()
    gbuf = rng.uniform(-1, 1, (16, BH, W)).astype(np.float32)
    gbuf[8] = rng.integers(0, 2, (BH, W))
    out = tg.world_pos_from_depth(t_(d), quads["tc"], W, BH, full_height=H,
                                  y_offset=band * BH)
    ref = jg.world_pos_from_depth(jnp.asarray(d), quads["jc"], W, BH,
                                  full_height=H, y_offset=band * BH)
    assert_bitwise(out, ref, "wpos")
    a, m = tg._attrs_from_gbuf(quads["ts"], quads["tc"], t_(d), tri_id[rows],
                               t_(gbuf), W, BH, full_height=H,
                               y_offset=band * BH)
    ra, rm = jg._attrs_from_gbuf(quads["jscene"], quads["jc"], jnp.asarray(d),
                                 jnp.asarray(tri_id[rows].numpy()),
                                 jnp.asarray(gbuf), W, BH, full_height=H,
                                 y_offset=band * BH)
    assert_bitwise(m, rm, "mask")
    for k in ("wpos", "wnrm", "wtan", "uv", "mrow", "ids"):
        assert_bitwise(a[k], ra[k], k)


@pytest.mark.parametrize("band", BANDS)
def test_band_raster_rows_are_the_frames(quads, band):
    """The band renderer's rasters (parallel/multichip._render_band):
    raster.rasterize_gbuf_band on the frame's setup cut by
    raster.rows_of_setup to the frame's rows up to the band's end gives the
    band's rows of depth, tri_id, G-buffer and coverage bit for bit as the
    whole frame's raster, with MSAA and with a depth window behind the
    front surface (the peels' bounded raster, the band's window widened
    with empty windows)."""
    setup, extra = tg.geometry_setup_gbuf(quads["ts"], quads["tc"], W, H)
    whole = tr.bin_triangles(setup, W, H, extra=extra)
    full = tr.rasterize_gbuf(whole, W, H, msaa=True)
    y0 = band * BH
    end = tr.band_end(y0, BH, H)
    assert end > BH or band == 0
    binned = tr.bin_triangles(tr.rows_of_setup(setup, end), W, end,
                              extra=extra)
    part = tr.rasterize_gbuf_band(binned, W, BH, y0, H, msaa=True)
    for what, a, b in zip(("depth", "tri_id", "gbuf", "coverage"), part, full):
        assert_bitwise(a, b.narrow(b.ndim - 2, y0, BH), what)
    zlo, zhi = full[0], torch.full_like(full[0], 2.0)
    behind = tr.rasterize_gbuf(whole, W, H, zbound=(zlo, zhi))
    part = tr.rasterize_gbuf_band(binned, W, BH, y0, H,
                                  zbound=(zlo[y0:y0 + BH], zhi[y0:y0 + BH]))
    for what, a, b in zip(("depth", "tri_id", "gbuf"), part, behind):
        assert_bitwise(a, b.narrow(b.ndim - 2, y0, BH), "bounded " + what)
    assert bool((behind[1][y0:y0 + BH] >= 0).any()) or band != 1


# ---------------------------------------------------------------------------
# the sky's quarter rows, the mip jitter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("band", BANDS)
def test_sky_band_matches_jax(quads, band):
    """_sky_quarter_dirs with y_offset and out_rows (a band's quarter rows
    of the frame's grid), and _axis_up4 with the neighbours' rows as prev
    and nxt: bitwise."""
    out = tg._sky_quarter_dirs(quads["tc"], W, H, y_offset=band * BH,
                               out_rows=BH)
    ref = jg._sky_quarter_dirs(quads["jc"], W, H, y_offset=band * BH,
                               out_rows=BH)
    assert_bitwise(out, ref, "dirs")
    whole = tg._sky_quarter_dirs(quads["tc"], W, H)
    assert_bitwise(out, whole[band * BH // 4:(band + 1) * BH // 4], "rows")
    q = np.random.default_rng(band).uniform(0, 4, (H // 4, W // 4, 3)).astype(np.float32)
    qp = halo_rows(q, band * BH // 4, BH // 4, 1)
    out = tg._axis_up4(t_(qp[1:-1]), 0, BH, prev=t_(qp[:-2]), nxt=t_(qp[2:]))
    ref = jg._axis_up4(jnp.asarray(qp[1:-1]), 0, BH, prev=jnp.asarray(qp[:-2]),
                       nxt=jnp.asarray(qp[2:]))
    assert_bitwise(out, ref, "up4")
    # the halo rows make the band the whole frame's rows
    assert_bitwise(out, tg._axis_up4(t_(q), 0, H)[band * BH:(band + 1) * BH])


@pytest.mark.parametrize("band", BANDS)
def test_mip_jitter_band_matches_jax(band):
    """mip_jitter at a band's frame rows: bitwise the reference's, and the
    whole frame's rows."""
    out = tt.mip_jitter(BH, W, y_offset=band * BH)
    assert_bitwise(out, jt.mip_jitter(BH, W, y_offset=band * BH))
    assert_bitwise(out, tt.mip_jitter(H, W)[band * BH:(band + 1) * BH])


# ---------------------------------------------------------------------------
# SSAO and the SSR denoiser
# ---------------------------------------------------------------------------

def _ssao_inputs(seed: int):
    """A half-resolution frame [54, 96]: a depth step, noise on the far
    part, normals tilted about the view axis."""
    rng = np.random.default_rng(seed)
    h2, w2 = H // 2, W // 2
    zv = np.full((h2, w2), 10.6, np.float32)
    zv[:, : w2 // 2] = 10.0
    zv[: h2 // 3] = 10.3
    zv += rng.uniform(0, 0.3, (h2, w2)).astype(np.float32) * (zv > 10.5)
    near, far = 0.1, 100.0
    depth = ((far / (far - near)) * (1.0 - near / zv)).astype(np.float32)
    n = rng.normal(size=(h2, w2, 3)).astype(np.float32) * 0.3
    n[..., 2] = -1.0
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return depth, n.astype(np.float32)


@pytest.mark.parametrize("preset", ["medium", "adaptive"])
@pytest.mark.parametrize("band", BANDS)
def test_ssao_band_matches_jax(band, preset):
    """ssao on a band's half-resolution slab with an 8-row halo, y_offset
    the slab's first frame row (negative for the first band) and
    full_height the frame's: bitwise, dense and deinterleaved with the
    adaptive refinement (even band heights and offsets)."""
    from vqengine_tpu.utils import math3d as jm3
    from vqengine_tpu_torch.utils import math3d as tm3
    depth, n = _ssao_inputs(7)
    pad, rows, y0 = 8, BH // 2, band * BH // 2
    dp, npad = halo_rows(depth, y0, rows, pad), halo_rows(n, y0, rows, pad)
    base = {"near": 0.1, "far": 100.0, "fov_y": np.deg2rad(60.0)}
    view = tm3.look_at_lh((0, 0, 0), (0, 0, 5))
    taps, extra, deint = tssao.PRESETS[preset]
    kw = dict(radius_world=2.0, num_taps=taps, adaptive_taps=extra,
              deinterleave=deint, y_offset=y0 - pad, full_height=H // 2)
    out = tssao.ssao(t_(dp), t_(npad), {**base, "view": t_(view)}, **kw)
    ref = jssao.ssao(jnp.asarray(dp), jnp.asarray(npad),
                     {**base, "view": jnp.asarray(jm3.look_at_lh(
                         (0, 0, 0), (0, 0, 5)))}, **kw)
    assert_bitwise(out, ref)
    assert float(out.min()) < 0.9


def _denoise_band_inputs(band: int):
    rng = np.random.default_rng(40 + band)
    hh, ww, rows = H // 2, W // 2, BH // 2
    refl = rng.uniform(0, 1, (rows, ww, 3)).astype(np.float32)
    conf = rng.uniform(0, 1, (rows, ww)).astype(np.float32)
    rough = rng.uniform(0, 1, (rows, ww)).astype(np.float32)
    depth = rng.uniform(5, 40, (rows, ww)).astype(np.float32)
    hist = np.concatenate([
        rng.uniform(0, 2, (hh, ww, 3)), rng.uniform(5, 40, (hh, ww, 1)),
        rng.uniform(0, 1, (hh, ww, 1)), rng.uniform(0, 1.5, (hh, ww, 1)),
        rng.integers(0, 33, (hh, ww, 1))], -1).astype(np.float32)
    # up to +-8 rows: the reprojection reaches the neighbouring bands
    motion = (rng.uniform(-8, 8, (rows, ww, 2)) / np.array([ww * 0.5, hh * 0.5])
              ).astype(np.float32)
    return refl, conf, rough, depth, hist, motion


@pytest.mark.parametrize("motion", [True, False], ids=["motion", "still"])
@pytest.mark.parametrize("band", BANDS)
def test_denoise_band_matches_jax(band, motion):
    """denoise_reflections on a band with the whole frame's history,
    y_offset and full_height: with motion the reprojection lands at frame
    rows (also in other bands), without it the band's rows of the history
    are taken; output and new history bitwise."""
    refl, conf, rough, depth, hist, mo = _denoise_band_inputs(band)
    kw = dict(depth=depth, history=hist, y_offset=band * BH // 2,
              full_height=H // 2)
    if motion:
        kw["motion"] = mo
    out = tssr.denoise_reflections(t_(refl), t_(conf), t_(rough),
                                   **{k: t_(v) if isinstance(v, np.ndarray) else v
                                      for k, v in kw.items()})
    ref = jssr.denoise_reflections(jnp.asarray(refl), jnp.asarray(conf),
                                   jnp.asarray(rough),
                                   **{k: jnp.asarray(v) if isinstance(v, np.ndarray)
                                      else v for k, v in kw.items()})
    assert_bitwise(out[0], ref[0], "denoised")
    assert_bitwise(out[1], ref[1], "history")
    if motion:
        idx = tssr.reproject_index(t_(mo), BH // 2, W // 2, band * BH // 2, H // 2)
        rows = torch.div(idx, W // 2, rounding_mode="floor")
        outside = (rows < band * BH // 2) | (rows >= (band + 1) * BH // 2)
        assert bool(outside.any())


# ---------------------------------------------------------------------------
# the MSAA edge resolves with a one-row halo; the alpha-mask peel
# ---------------------------------------------------------------------------

def _band_edges(quads, band: int):
    """A band of the quads' frame as the band renderer holds it: the frame's
    records, its G-buffer rows, the 1-row halo of tri_id, depth, object id
    and mask, and seeded hdr (the band's and its halo) -> (port inputs, the
    reference's whole-frame inputs)."""
    depth, tri_id, attrs, mask, cov = quads["geo"]
    y0 = band * BH
    rows = slice(y0, y0 + BH)
    setup, extra = tg.geometry_setup_gbuf(quads["ts"], quads["tc"], W, H)
    records = tr.pack_records(setup, extra)
    jsetup = jr.TriangleSetup(**{f.name: jnp.asarray(getattr(setup, f.name).numpy())
                                 for f in dataclasses.fields(tr.TriangleSetup)})
    jrecords = jr.pack_records(jsetup, jnp.asarray(extra.numpy()))
    ids = attrs["ids"][rows]
    obj = attrs["ids"][..., 0].to(torch.int32).numpy()
    hdr = np.random.default_rng(30 + band).uniform(0, 2, (H, W, 3)).astype(np.float32)
    halo = tuple(halo_rows(x, y0, BH, 1) for x in
                 (tri_id.numpy(), depth.numpy(), obj, mask.numpy()))
    port = dict(attrs={"ids": ids, "records": records,
                       "wpos": attrs["wpos"][rows]},
                tri_id=tri_id[rows], depth=depth[rows], mask=mask[rows],
                cov=cov[:, rows].contiguous(), hdr=t_(hdr[rows]),
                halo=tuple(t_(x) for x in halo),
                hdr_halo=t_(halo_rows(hdr, y0, BH, 1)))
    ref = dict(attrs={"ids": jnp.asarray(attrs["ids"].numpy()),
                      "records": jrecords,
                      "wpos": jnp.asarray(attrs["wpos"].numpy())},
               tri_id=jnp.asarray(tri_id.numpy()),
               depth=jnp.asarray(depth.numpy()), mask=jnp.asarray(mask.numpy()),
               cov=jnp.asarray(cov.numpy()), hdr=jnp.asarray(hdr))
    return port, ref


@pytest.mark.parametrize("band", BANDS)
def test_msaa_edge_neighbor_band_matches_jax(quads, band):
    """The neighbour-colour edge resolve of a band with its halo slabs, the
    frame's records evaluated at frame rows (y_offset) and the frame's
    capacity, against the reference's whole-frame resolve: the band's rows
    of the secondary weight and colour bitwise, and the band has edges."""
    p, r = _band_edges(quads, band)
    w, rgb = tg._msaa_edge_neighbor(p["attrs"], p["tri_id"], p["depth"],
                                    p["mask"], p["cov"], p["hdr"], W, BH,
                                    halo=p["halo"], hdr_halo=p["hdr_halo"],
                                    cap=tg.msaa_edge_cap(W, H),
                                    y_offset=band * BH)
    rw, rrgb = jg._msaa_edge_neighbor(r["attrs"], r["tri_id"], r["depth"],
                                      r["mask"], r["cov"], r["hdr"], W, H)
    rows = slice(band * BH, (band + 1) * BH)
    assert_bitwise(w, np.asarray(rw)[rows], "w_sec")
    assert_bitwise(rgb, np.asarray(rrgb)[rows], "sec_rgb")
    if band == 1:                     # the quads cross in the middle band
        assert float(w.max()) > 0


@pytest.mark.parametrize("band", BANDS)
def test_msaa_edge_secondary_band_matches_jax(quads, band):
    """The "shade" edge resolve of a band with its halo, the frame's records
    and capacity, full_height and y_offset (the secondary surface
    interpolated and unprojected at its frame row), with seeded shadow
    visibility, against the reference's whole-frame resolve: the band's
    rows of the weight bitwise, of the colour within GBUF_TOL."""
    p, r = _band_edges(quads, band)
    rng = np.random.default_rng(50 + band)
    vis = [rng.random(shape).astype(np.float32)
           for shape in ((1, H, W), (1, H, W), (H, W))]
    rows = slice(band * BH, (band + 1) * BH)
    w, rgb = tg._msaa_edge_secondary(
        quads["ts"], quads["tc"], p["attrs"], p["tri_id"], p["depth"],
        p["mask"], p["cov"], *(t_(v[..., rows, :]) for v in vis), W, BH, True,
        halo=p["halo"], full_height=H, y_offset=band * BH,
        cap=tg.msaa_edge_cap(W, H))
    rw, rrgb = jg._msaa_edge_secondary(
        quads["jscene"], quads["jc"], None, None, r["attrs"], r["tri_id"],
        r["depth"], r["mask"], r["cov"], None, None,
        *(jnp.asarray(v) for v in vis), W, H, 0, None, True)
    assert_bitwise(w, np.asarray(rw)[rows], "w_sec")
    np.testing.assert_allclose(rgb.numpy(), np.asarray(rrgb)[rows], rtol=0,
                               atol=GBUF_TOL)


@pytest.mark.parametrize("band", [0, 1])
def test_alpha_mask_peel_band_matches_jax(material_alpha_of_rows, band):
    """_alpha_mask_peel on a band (half the frame of tests/test_torch_
    transparency.py's cutout scene) with full_height and y_offset, as the
    band renderer runs it: the band's rows of the frame's raster, and the
    frame's binning of its rows up to the band's end. Against the
    reference's whole-frame peel (its material_pass given the row's alpha,
    as there), the band's rows: depth, tri_id, mask and the material keys
    bitwise, wpos and n within HDR_TOL."""
    bh, y0 = TH // 2, band * TH // 2
    ps, _, pc = port_scene("cutout", split=False)
    js, _, jc = jax_scene("cutout", split=False)
    setup, extra = tg.geometry_setup_gbuf(ps, pc, TW, TH)
    end = tr.band_end(y0, bh, TH)
    binned = tr.bin_triangles(tr.rows_of_setup(setup, end), TW, end,
                              extra=extra)
    depth, tri_id, gbuf = tr.rasterize_gbuf_band(binned, TW, bh, y0, TH)
    attrs, mask = tg._attrs_from_gbuf(ps, pc, depth, tri_id, gbuf, TW, bh,
                                      full_height=TH, y_offset=y0)
    mat = tg.material_pass(tg.unit3(attrs["wnrm"]), attrs["mrow"], attrs["ids"])
    out = tg._alpha_mask_peel(ps, pc, binned, TW, bh, depth, tri_id, mask,
                              attrs["wpos"], mat["normal"], mat, None,
                              full_height=TH, y_offset=y0)
    jb = _jax_binned(tr.bin_triangles(setup, TW, TH, extra=extra))
    with compiled_rasters():
        jd, jtid, jgbuf = jr.rasterize_gbuf(jb, TW, TH)
        ja, jmask = jg._attrs_from_gbuf(js, jc, jd, jtid, jgbuf, TW, TH)
        wn = ja["wnrm"]
        wn = wn / jnp.maximum(jnp.linalg.norm(wn, axis=-1, keepdims=True), 1e-9)
        jmat = jg.material_pass(js, jtid, uv=ja["uv"], wnrm=wn, wtan=ja["wtan"],
                                mrow=ja["mrow"], ids=ja["ids"])
        ref = jg._alpha_mask_peel(js, jc, jb, TW, TH, jd, jtid, jmask,
                                  ja["wpos"], jmat["normal"], jmat, None, None,
                                  0, None, None)
    rows = slice(y0, y0 + bh)
    for what, a, b in zip(("depth", "tri_id", "mask"), out[:3], ref[:3]):
        assert_bitwise(a, np.asarray(b)[rows], what)
    np.testing.assert_allclose(out[3].numpy(), np.asarray(ref[3])[rows],
                               rtol=0, atol=HDR_TOL)
    np.testing.assert_allclose(out[4].numpy(), np.asarray(ref[4])[rows],
                               rtol=0, atol=HDR_TOL)
    for k in tg.MATERIAL_PEEL_KEYS:
        assert_bitwise(out[5][k], np.asarray(ref[5][k])[rows], k)
    assert int((mask & (mat["alpha"] < 0.01)).sum()) > 0


# ---------------------------------------------------------------------------
# the halo exchange, the history's shards and the gathered frames
# ---------------------------------------------------------------------------

class _ThreadGroup:
    """An all_gather among threads (one per rank of a group): each call
    waits for every member's slab and returns them in rank order."""

    def __init__(self, n: int):
        self.n = n
        self.barrier = threading.Barrier(n)
        self.slots = [None] * n

    def all_gather(self, i: int, x: torch.Tensor) -> torch.Tensor:
        self.slots[i] = x.clone()
        self.barrier.wait()
        out = torch.cat(self.slots, dim=0)
        self.barrier.wait()
        return out


@dataclasses.dataclass
class _ThreadMesh(tmc.Mesh):
    """multichip.Mesh whose collectives run among threads (the sp groups and
    the world), for a single-process check of the band logic."""
    rows: list = None
    world: _ThreadGroup = None

    def all_gather(self, x, world=False):
        if world:
            return self.world.all_gather(self.rank, x)
        return self.rows[self.dp_index].all_gather(self.band, x)


def _run_ranks(dp: int, sp: int, fn) -> list:
    """fn(mesh) on dp x sp threads -> results by rank."""
    rows = [_ThreadGroup(sp) for _ in range(dp)]
    world = _ThreadGroup(dp * sp)
    out = [None] * (dp * sp)
    errors = []

    def body(r):
        try:
            mesh = _ThreadMesh(dp=dp, sp=sp, rank=r, group=None, device=CPU,
                               backend="gloo", rows=rows, world=world)
            out[r] = fn(mesh)
        except BaseException as e:          # surfaced below
            errors.append(e)
            rows[r // sp].barrier.abort()
            world.barrier.abort()
    threads = [threading.Thread(target=body, args=(r,)) for r in range(dp * sp)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors
    return out


@pytest.mark.parametrize("pad,dp,sp", [(1, 1, 4), (8, 1, 4), (2, 4, 1)],
                         ids=["pad1", "pad8", "one_band"])
def test_halo_exchange_matches_jax(pad, dp, sp):
    """_halo_exchange on 4 ranks against the reference's under a shard_map
    over 4 of the 8 virtual devices (dp x sp; sp = 1 takes the branch of
    one band, which edge-clamps both sides): every rank's padded slab
    equal to the reference's shard, bool slabs too (they cross as uint8)."""
    rng = np.random.default_rng(pad)
    rows = 16
    x = rng.normal(size=(4 * rows, 5, 3)).astype(np.float32)
    m = rng.random((4 * rows, 5)) < 0.5
    mesh = jmc.make_mesh(jax.devices()[:4], dp=dp, sp=sp)
    spec = P(("dp", "sp"))
    ref = [np.asarray(shard_map(lambda a: jmc._halo_exchange(a, pad), mesh=mesh,
                                in_specs=spec, out_specs=spec,
                                check_vma=False)(jnp.asarray(v)))
           for v in (x, m)]
    out = _run_ranks(dp, sp, lambda mesh_: [
        tmc._halo_exchange(t_(v[mesh_.rank * rows:(mesh_.rank + 1) * rows]),
                           pad, mesh_) for v in (x, m)])
    for k in range(2):
        got = torch.cat([o[k] for o in out]).numpy()
        assert got.dtype == ref[k].dtype
        assert_bitwise(got, ref[k], ["float", "bool"][k])


def test_frame_edge_threshold_is_the_frames():
    """The band renderer's MSAA edge threshold (multichip._frame_edge_
    threshold): every band of a seeded edge-score frame, its block counts
    gathered over the bands, picks the rung the whole frame picks
    (sparse.adaptive_threshold at the frame's capacity), at capacities
    where the frame takes the base rung, a middle one and the top one."""
    from vqengine_tpu_torch.ops import msaa as tmsaa
    from vqengine_tpu_torch.ops import sparse as tsp
    rng = np.random.default_rng(8)
    score = rng.choice(np.array([0.0, 1.0, 2.0, 3.0, 5.0], np.float32),
                       size=(H, W), p=[0.6, 0.15, 0.1, 0.1, 0.05])
    for cap in (4096, 1024, 64):
        want = float(tsp.adaptive_threshold(t_(score), tmsaa.EDGE_THRS, cap,
                                            block=8)[0])
        got = _run_ranks(1, SP, lambda mesh: float(tmc._frame_edge_threshold(
            t_(score[mesh.band * BH:(mesh.band + 1) * BH]), mesh, cap)))
        assert got == [want] * SP, (cap, got, want)
    assert want == tmsaa.EDGE_THRS[-1]


def test_shard_history_and_gather_frames_round_trip():
    """shard_history splits [dp, H/2, W/2, 7] (numpy, as the JAX package
    lays it out) into each rank's band slabs; gather_frames puts ldr-,
    depth- and history-shaped band stacks of every rank back in frame
    order, on every rank: bitwise round trips on dp 2 x sp 3, two frames
    per dp index."""
    dp, sp, per = 2, 3, 2
    rng = np.random.default_rng(5)
    hist = rng.normal(size=(dp * per, H // 2, W // 2, 7)).astype(np.float32)
    ldr = rng.random((dp * per, H, W, 3)).astype(np.float32)
    depth = rng.random((dp * per, H, W)).astype(np.float32)

    def rank(mesh):
        h = tmc.shard_history(hist, mesh)
        f = slice(mesh.dp_index * per, (mesh.dp_index + 1) * per)
        b = slice(mesh.band * BH, (mesh.band + 1) * BH)
        assert tuple(h.shape) == (per, BH // 2, W // 2, 7)
        return tmc.gather_frames(mesh, t_(ldr[f, b]), t_(depth[f, b]), h)
    for got in _run_ranks(dp, sp, rank):
        for a, b in zip(got, (ldr, depth, hist)):
            assert_bitwise(a, b)
