"""The reject tests of the raster kernels' stream (ops/raster.py
reject_block and depth_reject_block, the plain mirrors of
raster_common.cuh's reject_record and of K2's occlusion reject) and the
restated raster bounds (raster.covered_block_pairs, won_block_pairs), on
the CPU without JAX.

The kernels may skip a (record, pixel block) pair only where the record
changes nothing there; these tests hold the mirrors to that on crafted,
rendered and drawn records, at every level the kernels test (the tile, a
warp's 32x8 footprint) and below it (8x4 blocks, single pixels), in the
three sample modes (K1's CENTER and COVERAGE, K2's CENTER and SAMPLES4)."""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from vqengine_tpu_torch.entry import HEIGHT, WIDTH, entry
from vqengine_tpu_torch.ops import raster as tr
from vqengine_tpu_torch.ops import raster_probes, shadow
from vqengine_tpu_torch.render import graph

torch.set_num_threads(1)

CPU = torch.device("cpu")
MODES = (tr.CENTER, tr.COVERAGE)
XS = 2.0 * torch.arange(tr.TILE_W, dtype=torch.float32) + 1.0
YS = 2.0 * torch.arange(tr.TILE_H, dtype=torch.float32) + 1.0
# (block height, block width): the tile, a warp's footprint, the bound's
# block, one pixel
LEVELS = ((tr.TILE_H, tr.TILE_W), (tr.FOOT_H, tr.FOOT_W),
          (tr.BLOCK_H, tr.BLOCK_W), (1, 1))


def violations(rec, x0, y0, live, mode) -> dict:
    """(record, block) pairs the mirror rejects although the plain split
    evaluation finds the record covering something in the block, and the
    covered pairs, per level: rec [C, G, 12], x0/y0 [C], live [C]."""
    cov = tr.record_covers(mode, rec, *tr._plane_eval_split(rec, x0, y0, XS, YS))
    cov = cov & live[:, None, None]
    c, g = rec.shape[:2]
    out = {}
    for bh, bw in LEVELS:
        ny, nx = tr.TILE_H // bh, tr.TILE_W // bw
        hit = cov.view(c, g, ny, bh, nx, bw).any(dim=5).any(dim=3)
        r0 = (torch.arange(ny) * bh)[:, None].expand(ny, nx)
        c0 = (torch.arange(nx) * bw)[None, :].expand(ny, nx)
        rej = tr.reject_block(rec[:, :, None, None, :], x0[:, None, None, None],
                              y0[:, None, None, None], (c0, c0 + bw - 1),
                              (r0, r0 + bh - 1), mode)
        out[(bh, bw)] = (int((rej & hit).sum()), int(hit.sum()))
    return out


def check_stream(binned, mode) -> dict:
    """violations over every group every tile streams -> covered pairs per
    level (asserting no violation)."""
    covered = {lv: 0 for lv in LEVELS}
    for x0, y0, rec, live in tr.streamed_groups(binned):
        for lv, (bad, hit) in violations(rec, x0, y0, live, mode).items():
            assert bad == 0, (lv, bad)
            covered[lv] += hit
    return covered


def _entry_binned():
    _, (scene, consts) = entry(CPU)
    setup, extra = graph.geometry_setup_gbuf(scene, consts, WIDTH, HEIGHT)
    return tr.bin_triangles(setup, WIDTH, HEIGHT, extra=extra)


def _entry_light_view():
    """The entry scene seen through its camera as a 64^2 shadow view (16-row
    records, shadow.bin_shadow_view)."""
    _, (scene, consts) = entry(CPU)
    return shadow.bin_shadow_view(scene.positions, scene.item_of_vertex,
                                  consts.world, consts.view_proj,
                                  scene.indices, 64)


INPUTS = {
    "reject_probe": lambda: raster_probes.reject_probe()[0],
    "msaa_probe": lambda: raster_probes.msaa_probe()[0],
    "bounded_probe": lambda: raster_probes.bounded_probe()[0],
    "entry_256x128": _entry_binned,
    "depth_reject_probe": lambda: raster_probes.depth_reject_probe()[0],
    "entry_light_64": _entry_light_view,
}
K1_INPUTS = ("bounded_probe", "entry_256x128", "msaa_probe", "reject_probe")


# K1's inputs in its two modes; SAMPLES4 (K2-msaa4) on the crafted records
# and a light view
@pytest.mark.parametrize("name,mode", [
    *((n, m) for n in K1_INPUTS for m in MODES),
    ("reject_probe", tr.SAMPLES4), ("depth_reject_probe", tr.SAMPLES4),
    ("entry_light_64", tr.SAMPLES4)])
def test_reject_keeps_every_covered_pair(name, mode):
    """The mirror never rejects a (record, block) pair that the plain split
    evaluation covers, at the tile, the warp footprint, the 8x4 block and
    the pixel, on every record each tile streams."""
    covered = check_stream(INPUTS[name](), mode)
    assert covered[(1, 1)] > 0


def test_reject_probe_reaches_the_margin():
    """reject_probe's records sit where the margin decides: in each mode,
    its accepted-side margin records of the mode's targets cover their
    corner pixel, which lies in a footprint whose other pixels they miss,
    and its reach records cover pixels of the tile they are not listed
    in."""
    binned, _, info = raster_probes.reject_probe()
    w, h = raster_probes.REJECT_W, raster_probes.REJECT_H
    targets = {tr.CENTER: ("edge0", "z0"), tr.COVERAGE: ("thr", "z0", "z1")}
    for mode in MODES:
        out = tr.rasterize_gbuf(binned, w, h, msaa=mode == tr.COVERAGE)
        tri = out[1]
        won = [int(tri[y, x]) == row for row, g, side, (x, y) in info["margin"]
               if side and g in targets[mode] and x < w and y < h]
        assert sum(won) >= len(won) - 1 and len(won) >= 4, won
        ty = torch.arange(h)[:, None] // tr.TILE_H
        tile = ty * raster_probes.REJECT_TILES_X + torch.arange(w)[None, :] // tr.TILE_W
        for row, home, reached in info["reach"]:
            assert int(((tri == row) & (tile == reached)).sum()) > 0, (home, reached)
    assert info["killed"] and info["near_plane"] and info["degenerate"]


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), tx=st.integers(0, 15),
       ty=st.integers(0, 70), log_scale=st.integers(-30, 30),
       steps=st.integers(-40, 40),
       mode=st.sampled_from((*MODES, tr.SAMPLES4)))
def test_reject_keeps_drawn_records(seed, tx, ty, log_scale, steps, mode):
    """Drawn records at a drawn tile: each plane passes near a drawn pixel
    centre, its constant moved by a drawn number of small steps, all
    coefficients scaled by 2^log_scale; no covered pair is rejected."""
    rng = np.random.default_rng(seed)
    g = tr.GROUP
    x0, y0 = float(tx * tr.TILE_W), float(ty * tr.TILE_H)
    rec = np.zeros((g, 12), np.float64)
    for p in range(4):
        a = rng.standard_normal(g) * 10.0 ** rng.uniform(-3, 1, g)
        b = rng.standard_normal(g) * 10.0 ** rng.uniform(-3, 1, g)
        px = x0 + rng.integers(0, tr.TILE_W, g) + 0.5
        py = y0 + rng.integers(0, tr.TILE_H, g) + 0.5
        c = -(a * px + b * py)
        if p == 3:                  # depth near 0 or 1 there
            c = c + rng.choice([0.0, 1.0], g)
        c = c + steps * np.abs(c) * 2.0 ** -20 * rng.uniform(0, 1, g)
        rec[:, 3 * p:3 * p + 3] = np.stack([a, b, c], 1)
    rec = torch.from_numpy((rec * 2.0 ** log_scale).astype(np.float32))
    v = violations(rec[None], torch.tensor([x0]), torch.tensor([y0]),
                   torch.tensor([True]), mode)
    assert all(bad == 0 for bad, _ in v.values()), v


@pytest.mark.parametrize("mode", (*MODES, tr.SAMPLES4))
def test_reject_drops_killed_records(mode):
    """A killed record (e'0 = (0, 0, -1)) is rejected at every tile origin
    and every level, and so costs no evaluation."""
    k = tr.killed_record(tr.GBUF_ROWS, CPU)[:12]
    for ty in (0, 7, 67):
        for tx in (0, 3, 14):
            x0 = torch.tensor(float(tx * tr.TILE_W))
            y0 = torch.tensor(float(ty * tr.TILE_H))
            for bh, bw in LEVELS[:3]:
                for r0 in range(0, tr.TILE_H, bh):
                    for c0 in range(0, tr.TILE_W, bw):
                        assert bool(tr.reject_block(
                            k, x0, y0, (c0, c0 + bw - 1), (r0, r0 + bh - 1), mode))


def _quad_binned(width: int, height: int):
    """One tile's stream of one group: a record whose edges x >= 7.8,
    x <= 24.2 and y >= 4 cut the tile to a quad (z = 0.5), then killed
    records."""
    pairs = tr.killed_record(tr.GBUF_ROWS, CPU).expand(tr.GROUP, -1).clone()
    pairs[0, :12] = torch.tensor([1.0, 0.0, -7.8, -1.0, 0.0, 24.2,
                                  0.0, 1.0, -4.0, 0.0, 0.0, 0.5])
    pairs[0, 12] = 0.0
    i32 = torch.int32
    return tr.BinnedTriangles(
        pairs=pairs, starts=torch.tensor([0, 1], dtype=i32),
        rstarts=torch.tensor([128, 128], dtype=i32),
        gpairs=tr.killed_record(tr.GBUF_ROWS, CPU).expand(tr.GLOBAL_CAP, -1).clone(),
        gmeta=torch.tensor([0, 1], dtype=i32), overflow=torch.zeros(3, dtype=i32),
        demand=torch.tensor(1, dtype=i32), tiles_x=1, tiles_y=1, pair_cap=128)


@pytest.mark.parametrize("mode,width,height,count", [
    # centres x + 0.5 in [7.8, 24.2] -> columns 8..23, blocks 1-2 of 8
    # columns; rows 4..15, block rows 1-3 of 4 rows: 2 x 3
    (tr.CENTER, 128, 16, 6),
    # samples reach 3/8 further: columns 7 (7.875) .. 24 (24.125), blocks
    # 0-3; rows: 3.875 < 4, so rows 4..15 still: 4 x 3
    (tr.COVERAGE, 128, 16, 12),
    (tr.SAMPLES4, 128, 16, 12),
    # a 20 x 14 frame: columns 7..19, blocks 0-2; rows 4..13, blocks 1-3
    (tr.COVERAGE, 20, 14, 9),
])
def test_covered_block_pairs_hand_count(mode, width, height, count):
    assert tr.covered_block_pairs(_quad_binned(width, height), width, height,
                                  mode) == count


def test_won_block_pairs_hand_count():
    """_quad_binned's record wins columns 8..23, rows 4..15 (CENTER): 2 x 3
    blocks of 8x4; in a 20 x 14 frame columns 8..19, rows 4..13: 2 x 3."""
    for width, height in ((128, 16), (20, 14)):
        _, tri = tr.rasterize(_vis(_quad_binned(width, height)), width, height)
        assert tr.won_block_pairs(tri) == 6


def _vis(binned):
    return raster_probes.vis_records(binned)


DEPTH_INPUTS = {
    "depth_reject_probe": INPUTS["depth_reject_probe"],
    "reject_probe": lambda: _vis(raster_probes.reject_probe()[0]),
    "entry_light_64": _entry_light_view,
}


@pytest.mark.parametrize("name", sorted(DEPTH_INPUTS))
def test_depth_floor_below_every_computed_depth(name):
    """The occlusion reject's floor (depth_floor_block: Vmin - M of the
    depth plane) never exceeds the split-evaluated z at any pixel of the
    block, for every record each tile streams, at the warp footprint, the
    8x4 block and the pixel: so a record whose floor is at or above every
    carry of a footprint passes the strict z < depth nowhere in it."""
    checked = 0
    for x0, y0, rec, live in tr.streamed_groups(DEPTH_INPUTS[name]()):
        z = tr._plane_eval_split(rec, x0, y0, XS, YS)[3]
        c, g = rec.shape[:2]
        for bh, bw in LEVELS[1:]:
            ny, nx = tr.TILE_H // bh, tr.TILE_W // bw
            zb = z.view(c, g, ny, bh, nx, bw).double()
            r0 = (torch.arange(ny) * bh)[:, None].expand(ny, nx)
            c0 = (torch.arange(nx) * bw)[None, :].expand(ny, nx)
            floor = tr.depth_floor_block(
                rec[:, :, None, None, :], x0[:, None, None, None],
                y0[:, None, None, None], (c0, c0 + bw - 1), (r0, r0 + bh - 1))
            bad = (floor[:, :, :, None, :, None] > zb) & live[:, None, None, None,
                                                              None, None]
            assert int(bad.sum()) == 0, (name, bh, bw)
            checked += int(live.sum()) * g * ny * nx
    assert checked > 0


def test_depth_reject_probe_occlusion_count():
    """The mirror's occlusion reject, under the kernel's carries, drops
    exactly the (record, footprint) pairs that depth_reject_probe
    constructs as hidden, and the probe's records win their pixels."""
    binned, info = raster_probes.depth_reject_probe()
    counts = tr.reject_stream_counts(binned, tr.CENTER, occlusion=True)
    assert counts["occluded"] == sum(len(v) for v in info["occluded"].values())
    _, tri = tr.rasterize(binned, raster_probes.DEPTH_W, raster_probes.DEPTH_H)
    for rec, row in info["rows"].items():
        assert int((tri == row).sum()) == info["winners"].get(rec, 0), rec
