"""Parity of the port's raster front end, binning and G-buffer raster
(plain PyTorch version of kernel K1) with the JAX package on the entry()
scene at 256x128. JAX runs on the CPU, its Pallas kernel in interpret
mode; the same numpy inputs feed both."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from vqengine_tpu.ops import raster as jr
from vqengine_tpu.render import graph as jg
from vqengine_tpu_torch.ops import raster as tr
from vqengine_tpu_torch.render import graph as tg

torch.set_num_threads(1)

W, H = 256, 128
CPU = torch.device("cpu")


def leaves(dc) -> dict:
    return {f.name: None if getattr(dc, f.name) is None
            else np.asarray(getattr(dc, f.name))
            for f in dataclasses.fields(dc)}


def bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


@pytest.fixture(scope="module")
def front():
    """JAX and port triangle setup + extra columns of the entry frame.
    JAX runs op by op here, as its own tests call it: under jit, XLA's
    CPU backend contracts multiply-adds into FMAs across the fused setup
    arithmetic, which moves the ill-conditioned depth plane by up to
    ~4e-3 (see ROADMAP.md, queue 3)."""
    scene, consts = graft._tiny_scene_and_consts(W, H)
    js, jx = jg.geometry_setup_gbuf(scene, consts, W, H)
    ts = tg.device_scene_from_numpy(leaves(scene), scene.num_tris_live, CPU)
    tc = tg.frame_constants_from_numpy(leaves(consts), CPU)
    ps, px = tg.geometry_setup_gbuf(ts, tc, W, H)
    return js, jx, ps, px


@functools.cache
def _jax_bin(width, height, pair_capacity):
    return jax.jit(functools.partial(jr.bin_triangles, width=width,
                                     height=height,
                                     pair_capacity=pair_capacity))


@pytest.mark.parametrize("field", [f.name for f in
                                   dataclasses.fields(tr.TriangleSetup)])
def test_setup_bitwise(front, field):
    """Same operations in the same order: bitwise on this host."""
    js, _, ps, _ = front
    np.testing.assert_array_equal(bits(getattr(ps, field).numpy()),
                                  bits(getattr(js, field)))


def test_gbuf_extra_bitwise(front):
    """The bf16-pair words (normal+3 | tangent) and the id columns."""
    _, jx, _, px = front
    np.testing.assert_array_equal(bits(px.numpy()), bits(jx))


def test_pack_bf16_pair_bitwise():
    rng = np.random.default_rng(3)
    hi = (rng.standard_normal((257, 3)) + 3.0).astype(np.float32)
    lo = rng.standard_normal((257, 3)).astype(np.float32)
    ref = jr._pack_bf16_pair(jnp.asarray(hi), jnp.asarray(lo))
    out = tr.pack_bf16_pair(torch.from_numpy(hi), torch.from_numpy(lo))
    np.testing.assert_array_equal(bits(out.numpy()), bits(ref))


def test_records_bitwise(front):
    js, jx, ps, px = front
    np.testing.assert_array_equal(bits(tr.pack_records(ps, px).numpy()),
                                  bits(jr.pack_records(js, jx)))


def _jax_binned(pb: tr.BinnedTriangles) -> jr.BinnedTriangles:
    """The port's binning in the reference's layout ([NG, 32, 128])."""
    def blocks(a):
        return jnp.asarray(a.numpy().reshape(-1, jr.GROUP, tr.GBUF_ROWS)
                           .transpose(0, 2, 1))
    pairs = blocks(pb.pairs)
    return jr.BinnedTriangles(
        pairs=pairs, starts=jnp.asarray(pb.starts.numpy()), rpairs=pairs,
        rstarts=jnp.asarray(pb.rstarts.numpy()), gpairs=blocks(pb.gpairs),
        gmeta=jnp.asarray(pb.gmeta.numpy()),
        overflow=jnp.asarray(pb.overflow.numpy()),
        demand=jnp.asarray(pb.demand.numpy()), tiles_x=pb.tiles_x,
        tiles_y=pb.tiles_y, pair_cap=pb.pair_cap)


# None = the default T-sized cap; 256 pairs overflow the entry frame
@pytest.mark.parametrize("pair_capacity", [None, 256])
def test_binning_matches(front, pair_capacity):
    """Segment tables, counters and the triangle ids of every pair (so
    the order inside every segment) equal the reference's; the pair
    records are the port's records (bitwise equal to the reference's,
    test_records_bitwise) in that order."""
    js, jx, ps, px = front
    jb = _jax_bin(W, H, pair_capacity)(js, extra=jx)
    pb = tr.bin_triangles(ps, W, H, extra=px, pair_capacity=pair_capacity)
    for name in ("starts", "rstarts", "gmeta", "overflow", "demand"):
        np.testing.assert_array_equal(getattr(pb, name).numpy(),
                                      np.asarray(getattr(jb, name)), name)
    assert (pb.tiles_x, pb.tiles_y, pb.pair_cap) == (jb.tiles_x, jb.tiles_y,
                                                     jb.pair_cap)
    if pair_capacity is not None:
        assert int(pb.overflow[0]) > 0
    # [NG, 32, 128] lane blocks -> pair-major rows; row 12 is the id
    jp = np.asarray(jb.pairs).transpose(0, 2, 1).reshape(-1, tr.GBUF_ROWS)
    ids = pb.pairs[:, 12].numpy()
    np.testing.assert_array_equal(ids, jp[:, 12])
    rec = tr.pack_records(ps, px)
    live = ids >= 0
    expect = rec[torch.from_numpy(ids[live]).long()]
    np.testing.assert_array_equal(bits(pb.pairs[live].numpy()),
                                  bits(expect.numpy()))
    killed = tr.killed_record(tr.GBUF_ROWS, CPU)
    assert torch.equal(pb.pairs[~torch.from_numpy(live)],
                       killed.expand(int((~live).sum()), -1))
    jg_ = np.asarray(jb.gpairs).transpose(0, 2, 1).reshape(-1, tr.GBUF_ROWS)
    np.testing.assert_array_equal(bits(pb.gpairs.numpy()), bits(jg_))


def test_pair_demand(front):
    js, _, ps, _ = front
    assert int(tr.pair_demand_of(ps)) == int(jr.pair_demand_of(js))


@pytest.mark.parametrize("demand,t", [(0, None), (5800, 28928), (70000, None),
                                      (70000, 300000), (2_000_000, 4_000_000)])
def test_pair_cap_bucket(demand, t):
    assert tr.pair_cap_bucket(demand, t) == jr.pair_cap_bucket(demand, t)
    if t is not None:
        assert tr.default_pair_cap(t) == jr.default_pair_cap(t)


def test_rasterize_gbuf_matches(front):
    """The plain K1 against the Pallas kernel on the same binned input.
    tri_id: equal on >= 99.9% of pixels (all, measured). depth/gbuf
    within 1e-6 where ids agree: the plain version mirrors the kernel's
    split-eval order of additions and the two multiply-adds the reference
    rounds as FMAs on the CPU (measured bitwise on this host)."""
    _, _, ps, px = front
    pb = tr.bin_triangles(ps, W, H, extra=px)
    d, i, g = map(np.asarray, jax.jit(functools.partial(
        jr.rasterize_gbuf, width=W, height=H))(_jax_binned(pb)))
    d2, i2, g2 = (a.numpy() for a in tr.rasterize_gbuf(pb, W, H))
    assert (i2 >= 0).mean() > 0.1        # the frame shows geometry
    same = i == i2
    assert same.mean() >= 0.999
    np.testing.assert_allclose(d2[same], d[same], rtol=0, atol=1e-6)
    np.testing.assert_allclose(g2[:, same], g[:, same], rtol=0, atol=1e-6)


@pytest.mark.parametrize("kw", [dict(zbound=(torch.zeros(H, W),
                                             torch.ones(H, W)))])
def test_rasterize_gbuf_unported_variants_raise(front, kw):
    """The depth-bounded variant (which raised until it was ported): the
    window (0, 1) keeps every fragment of the entry frame (its depths lie
    inside), so the outputs equal the unbounded ones; the wrapper rejects a
    window of the wrong dtype, shape, device or arity."""
    _, _, ps, px = front
    pb = tr.bin_triangles(ps, W, H, extra=px)
    zlo, zhi = kw["zbound"]
    out = tr.rasterize_gbuf(pb, W, H, **kw)
    free = tr.rasterize_gbuf(pb, W, H)
    assert float((free[1] >= 0).float().mean()) > 0.1
    for a, b in zip(out, free):
        assert torch.equal(a, b)
    for bad in [(zlo.double(), zhi), (zlo, zhi[:, :-1]), (zlo[None], zhi),
                (zlo.to("meta"), zhi), (zlo,), zlo]:
        with pytest.raises(ValueError):
            tr.rasterize_gbuf(pb, W, H, zbound=bad)


@pytest.mark.parametrize("w,h", [(W, H), (250, 100), (100, 30)])
def test_tile_image_matches_jax(w, h):
    """The bounded kernel's window layout: [H, W] -> [NT, NPX] tiles,
    edge-padded to whole tiles, equal to the reference's tile_image."""
    img = np.random.default_rng(w).standard_normal((h, w)).astype(np.float32)
    tx, ty = tr.cdiv(w, tr.TILE_W), tr.cdiv(h, tr.TILE_H)
    out = tr.tile_image(torch.from_numpy(img), tx, ty)
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(jr.tile_image(jnp.asarray(img), tx, ty)))
