"""Crafted binned records on which the G-buffer raster (kernel K1) shows
the parts of its arithmetic that a rendered frame rarely or never
reaches: msaa_probe for the MSAA variant's sample arithmetic, and
bounded_probe for the depth-bounded variants' window (at the end).

- Threshold records: a per-sample threshold t_i = -(e_ix dx + e_iy dy)
  decides a sample's coverage only where b_i(center) falls between its two
  possible roundings (one rounding, or two rounded products added), which
  no rendered frame tested so far reaches. Each of these records is one
  pixel whose test edge passes through one sample, its coefficients
  searched so that b_i(center) lies between the two roundings: the sample
  is covered under the rounding the coverage bits use
  (raster.MSAA_COVERAGE_FUSED) and not under the other, or the reverse.
  Every sample and edge gets both directions. The test sample is the one
  furthest inside the edge, so the record covers no other sample and not
  the center, and whether it wins at all shows the rounding of the depth
  key's test (raster.MSAA_KEY_FUSED).
- Key records: a pixel where a center-covered record beats a nearer one
  that covers only a sample (key z against z + 1), and a pixel that two
  sample-only records share (the nearer one wins with key z + 1).
- A center-covered record at exactly z = 1 per tile, whose key 1.0 the
  un-bias turns into depth 0 (the reference's quirk, mirrored).
- Records past the counts: the first tile streams two groups and the
  others one (the last none), so most tiles' streams are shorter than the
  longest, and the global tier holds a record that covers the whole frame
  nearest of all but is not counted (gmeta[0] = 0): it must neither win
  nor add coverage anywhere.

The input has the layout of a binned frame of 4 x 4 tiles (WIDTH x HEIGHT
pixels, 16 groups of 128 records).
"""
from __future__ import annotations

import numpy as np
import torch

from . import raster

TILES_X, TILES_Y = 4, 4
WIDTH, HEIGHT = TILES_X * raster.TILE_W, TILES_Y * raster.TILE_H
PER_CASE = 2            # threshold records per (sample, edge, direction)
_A_LOW, _B_LOW = 64, 16  # low mantissa values searched per coefficient
_C_STEPS = 8            # constants searched each side of the first guess
_DRAWS = 64             # draws of (a, b) per round of the search


def _center_value(a, b, c, lx: int, ly: int):
    """The kernel's b(center) of edge (a, b, c) at pixel (lx, ly) of the
    first tile, for [N] coefficient vectors."""
    rec = torch.zeros((1, a.shape[0], 12), dtype=torch.float32)
    rec[0, :, 0], rec[0, :, 1], rec[0, :, 2] = a, b, c
    xs = torch.tensor([2.0 * lx + 1.0])
    ys = torch.tensor([2.0 * ly + 1.0])
    return raster._plane_eval_split(rec, torch.zeros(1), torch.zeros(1), xs,
                                    ys)[0][0, :, 0]


def _ulp(x: torch.Tensor) -> torch.Tensor:
    return torch.nextafter(x.abs(), torch.tensor(float("inf"))) - x.abs()


def _with_low_bits(x: torch.Tensor, n: int) -> torch.Tensor:
    """[D] f32 -> [D, n]: x with its lowest log2(n) mantissa bits set to
    0 .. n - 1."""
    bits = x.view(torch.int32)[:, None] & ~(n - 1)
    return (bits | torch.arange(n, dtype=torch.int32)).view(torch.float32)


def _search_threshold(rng, lx: int, ly: int, s: int, i: int, covered: bool):
    """Edge i's (a, b, c) through sample s of pixel (lx, ly) of the first
    tile, with its center value between the two roundings of its threshold:
    the sample's coverage bit set under MSAA_COVERAGE_FUSED's rounding iff
    `covered`, and no other sample (nor the center) inside the edge.

    The center value sees a and b only through their bf16 hi/lo parts,
    the threshold sees every bit: per draw of (a, b), the constant c is
    set to put the center value on the threshold and stepped around it,
    then the lowest mantissa bits of a and b are searched for a threshold
    whose two roundings straddle one of those center values; a pick is
    kept once its own evaluation confirms it."""
    dx, dy = raster.MSAA4_OFFSETS[s]
    fused = raster.MSAA_COVERAGE_FUSED[s][i]
    steps = torch.arange(-_C_STEPS, _C_STEPS + 1, dtype=torch.float32)
    for _ in range(16):
        a0, b0 = (torch.from_numpy((rng.uniform(0.5, 2.0, _DRAWS) * rng.choice(
            [-1.0, 1.0], _DRAWS)).astype(np.float32)) for _ in range(2))
        # sample s furthest inside the edge, by a margin
        inc = torch.stack([a0 * ox + b0 * oy for ox, oy in raster.MSAA4_OFFSETS])
        rest = torch.cat([inc[:s], inc[s + 1:]]).max(dim=0).values
        keep = inc[s] > rest + 0.01 * (a0.abs() + b0.abs())
        a0, b0 = a0[keep], b0[keep]
        # two corrections for the edge bias and the split's rounding
        t0 = raster.msaa_threshold(a0, b0, s, fused)
        c0 = -(a0 * (lx + 0.5 + dx) + b0 * (ly + 0.5 + dy))
        for _ in range(2):
            c0 = c0 + (t0 - _center_value(a0, b0, c0, lx, ly))
        # the split keeps about 16 bits of each constant: step by that
        step = torch.maximum(_ulp(c0), (a0.abs() + b0.abs() + c0.abs()) * 2.0 ** -18)
        c = c0[:, None] + steps * step[:, None]                   # [D, S]
        v = _center_value(a0[:, None].expand_as(c).reshape(-1),
                          b0[:, None].expand_as(c).reshape(-1), c.reshape(-1),
                          lx, ly).reshape(c.shape)
        a = _with_low_bits(a0, _A_LOW)[:, :, None].expand(-1, -1, _B_LOW)
        b = _with_low_bits(b0, _B_LOW)[:, None, :].expand(-1, _A_LOW, -1)
        a, b = a.reshape(len(a0), -1), b.reshape(len(a0), -1)     # [D, L]
        t_rule = raster.msaa_threshold(a, b, s, fused)
        t_other = raster.msaa_threshold(a, b, s, not fused)
        vv = v[:, :, None]
        hit = (((vv >= t_rule[:, None]) == covered)
               & ((vv >= t_other[:, None]) != covered))           # [D, S, L]
        for j, m, k in hit.nonzero().tolist()[:64]:
            ab = a[j, k:k + 1], b[j, k:k + 1]
            vk = _center_value(*ab, c[j, m:m + 1], lx, ly)
            if (bool((vk >= t_rule[j, k]) == covered)
                    and bool((vk >= t_other[j, k]) != covered)):
                return float(ab[0]), float(ab[1]), float(c[j, m])
    raise RuntimeError(f"no threshold record for sample {s}, edge {i}")


def _record(edges, zc: float, py: float) -> np.ndarray:
    """A K1 record: three edges (a, b, c) and a depth plane that is zc at
    the center of row py and rises by 1 per row, so that 0 <= z <= 1 holds
    in that row alone."""
    rec = np.zeros(raster.GBUF_ROWS, np.float32)
    for i, e in enumerate(edges):
        rec[3 * i:3 * i + 3] = e
    rec[9:12] = [0.0, 1.0, zc - (py + 0.5)]
    return rec


def _column(px: int) -> list:
    """The two edges that keep a record inside column px: x >= px,
    x <= px + 1 (every sample of the column passes both)."""
    return [(1.0, 0.0, -float(px)), (-1.0, 0.0, float(px) + 1.0)]


def msaa_probe(seed: int = 0, device: torch.device | str = "cpu"):
    """-> (BinnedTriangles of WIDTH x HEIGHT pixels, counts): the number of
    threshold records ("thresholds"), of pixels with two key records
    ("keys") and of z = 1 records ("z1")."""
    rng = np.random.default_rng(seed)
    nt = TILES_X * TILES_Y
    groups = [2] + [1] * (nt - 2) + [0]          # per tile; 16 in all
    starts = (np.concatenate([[0], np.cumsum(groups)]) * raster.GROUP
              ).astype(np.int32)
    killed = raster.killed_record(raster.GBUF_ROWS, torch.device("cpu")).numpy()
    pairs = np.tile(killed, (int(starts[-1]), 1))
    fill = starts[:-1].copy()                    # next free slot per tile
    used = [set() for _ in range(nt)]

    def put(t: int, rec: np.ndarray) -> None:
        if fill[t] >= starts[t + 1]:
            raise RuntimeError(f"tile {t} is full")
        rec[12] = fill[t]                        # the record's id: its row
        pairs[fill[t]] = rec
        fill[t] += 1

    def pixel(t: int, max_lx: int) -> tuple[int, float]:
        """A free pixel (px, py) of tile t (not in its last row)."""
        while True:
            lx = int(rng.integers(0, max_lx))
            ly = int(rng.integers(0, raster.TILE_H - 1))
            if (lx, ly) not in used[t]:
                used[t].add((lx, ly))
                return (t % TILES_X * raster.TILE_W + lx,
                        float(t // TILES_X * raster.TILE_H + ly))

    cases = [(s, i, cov) for s in range(4) for i in range(3)
             for cov in (True, False)] * PER_CASE
    for s, i, cov in cases:
        # near the first tile's origin, where the tile-origin fold is
        # exact and the split values resolve the threshold finely
        px, py = pixel(0, 16)
        edges = _column(px)
        edges.insert(i, _search_threshold(rng, px, int(py), s, i, cov))
        put(0, _record(edges, 0.5, py))
    live = range(nt - 1)                         # the tiles with records
    for t in live[1:]:
        # a center-covered record (z 0.75) and a nearer one (z 0.25)
        # covering sample 3 alone (y >= center + 0.2): the first wins
        px, py = pixel(t, raster.TILE_W)
        put(t, _record(_column(px) + [(0.0, 1.0, -(py + 0.4))], 0.75, py))
        put(t, _record(_column(px) + [(0.0, 1.0, -(py + 0.7))], 0.25, py))
        # two sample-only records: z 0.6 covering sample 3, z 0.3 covering
        # sample 1 (x >= center + 0.2): the second wins with key 1.3
        px, py = pixel(t, raster.TILE_W)
        put(t, _record(_column(px) + [(0.0, 1.0, -(py + 0.7))], 0.6, py))
        put(t, _record([(1.0, 0.0, -(px + 0.7)), (-1.0, 0.0, px + 1.0),
                        (0.0, 1.0, -py)], 0.3, py))
    for t in live:
        # in the tile's last row (y >= its top, the tile's end below) at
        # z = 1 exactly
        px = t % TILES_X * raster.TILE_W + int(rng.integers(0, raster.TILE_W))
        py = float(t // TILES_X * raster.TILE_H + raster.TILE_H - 1)
        rec = _record(_column(px) + [(0.0, 1.0, -py)], 0.0, py)
        rec[9:12] = [0.0, 0.0, 1.0]
        put(t, rec)
    gpairs = np.tile(killed, (raster.GLOBAL_CAP, 1))
    gpairs[0, 0:13] = [0, 0, 1, 0, 0, 1, 0, 0, 1, 0, 0, 0.01, len(pairs)]
    dev = torch.device(device)
    binned = raster.BinnedTriangles(
        pairs=torch.from_numpy(pairs).to(dev),
        starts=torch.from_numpy(starts).to(dev),
        rstarts=torch.full((TILES_Y + 1,), int(starts[-1]), dtype=torch.int32,
                           device=dev),
        gpairs=torch.from_numpy(gpairs).to(dev),
        gmeta=torch.tensor([0, TILES_X], dtype=torch.int32, device=dev),
        overflow=torch.zeros(3, dtype=torch.int32, device=dev),
        demand=torch.tensor(int((fill - starts[:-1]).sum()), dtype=torch.int32,
                            device=dev),
        tiles_x=TILES_X, tiles_y=TILES_Y, pair_cap=int(starts[-1]))
    return binned, {"thresholds": len(cases), "keys": 2 * (len(live) - 1),
                    "z1": len(live)}


# ---------------------------------------------------------------------------
# the depth-bounded variants (K1-bounded, both sample modes)
# ---------------------------------------------------------------------------

def _attr_record(rng, edges, plane) -> np.ndarray:
    """A K1 record: three edges (a, b, c), a depth plane and random
    attributes (packed normal/tangent pairs, uv, material/item and object
    ids)."""
    rec = np.zeros(raster.GBUF_ROWS, np.float32)
    rec[0:9] = np.asarray(edges, np.float32).reshape(-1)
    rec[9:12] = plane
    nrm = torch.from_numpy(rng.uniform(-1, 1, (3, 3)).astype(np.float32))
    tan = torch.from_numpy(rng.uniform(-1, 1, (3, 3)).astype(np.float32))
    attrs = torch.cat([raster.pack_bf16_pair(nrm + raster.NRM_PACK_BIAS, tan),
                       torch.from_numpy(rng.uniform(0, 1, (3, 2))
                                        .astype(np.float32))], dim=1)
    rec[13:28] = attrs.reshape(-1).numpy()
    rec[28] = float(rng.integers(0, 4) * 65536 + rng.integers(0, 64))
    rec[29] = float(rng.integers(0, 64))
    return rec


# a ragged frame of 2 x 2 tiles: the window's edge padding is read
BOUNDED_TILES = 2
BOUNDED_W = BOUNDED_TILES * raster.TILE_W - 16
BOUNDED_H = BOUNDED_TILES * raster.TILE_H - 4
BAND_Z = tuple(0.125 + k / 1024 for k in range(8))   # exact in bf16
GLOBAL_ID = 100_000
# per-pixel window classes, (zlo, zhi); "S" is the sloped record's own
# pixel-center depth, "S-" / "S+" its neighbouring floats
BOUNDED_WINDOWS = (
    (-1.0, 2.0),                 # 0 unbounded
    (0.125, 2.0),                # 1 band 0 on zlo
    (0.25, 2.0),                 # 2 the 0.25 record on zlo; 0.5 tie
    (-1.0, 0.125),               # 3 band 0 on zhi: nothing in front
    ("S", 2.0),                  # 4 the sloped record on zlo
    (-1.0, "S"),                 # 5 the sloped record on zhi
    ("S-", "S+"),                # 6 the sloped record alone
    (0.6, 0.4),                  # 7 empty (zlo > zhi)
    (0.25, 0.5),                 # 8 0.25 and 0.5 on the bounds
    (0.5, 2.0),                  # 9 0.75 tie: the global tier first
    (0.75, 0.75),                # 10 empty (zlo = zhi)
    (0.1, 0.2),                  # 11 the bands alone: sample-only
    (0.125, 0.2),                # 12 the bands but band 0
    (-1.0, BAND_Z[4]),           # 13 bands 0-3, band 4 on zhi
)


def bounded_probe(seed: int = 0, device: torch.device | str = "cpu"):
    """Crafted records and a per-pixel depth window for K1-bounded ->
    (BinnedTriangles of BOUNDED_W x BOUNDED_H pixels, (zlo, zhi) [H, W]
    f32, window class [H, W] int64: index into BOUNDED_WINDOWS, (x + 5 y)
    mod 14).

    Every tile streams one group: a record covering the frame whose depth
    slopes across it (0.3 to 0.74; row 0), two covering it at z = 0.5
    (rows 1 and 2: a tie, the first wins), one at z = 0.25 (row 3), 8
    slanted bands narrower than a pixel at z = BAND_Z (rows 4-11: pixels
    where they cover samples but not the center), and one covering the
    frame at z = 0.75 (row 12), which ties with a record of the global
    tier (streamed first, so it wins). Every depth but the sloped one is
    exact, so the windows put fragments exactly on zlo and zhi; the
    sloped record's own depths, taken from the unbounded plain raster,
    put it on a bound pixel by pixel. Each record carries random
    attributes."""
    rng = np.random.default_rng(seed)
    nt = BOUNDED_TILES * BOUNDED_TILES
    rows = raster.GBUF_ROWS
    killed = raster.killed_record(rows, torch.device("cpu")).numpy()

    def record(edges, plane) -> np.ndarray:
        return _attr_record(rng, edges, plane)

    cover = [(0.0, 0.0, 1.0)] * 3
    recs = [record(cover, (1.5e-3, 2e-3, 0.3)), record(cover, (0, 0, 0.5)),
            record(cover, (0, 0, 0.5)), record(cover, (0, 0, 0.25))]
    for k, z in enumerate(BAND_Z):
        # 0.8 pixels wide, x from 10 + 28 k + 0.37 y
        xk = 10.0 + 28.0 * k
        recs.append(record([(1.0, -0.37, -xk), (-1.0, 0.37, xk + 0.8),
                            (0.0, 0.0, 1.0)], (0, 0, z)))
    recs.append(record(cover, (0, 0, 0.75)))
    pairs = np.tile(killed, (nt * raster.GROUP, 1))
    for t in range(nt):
        for r, rec in enumerate(recs):
            row = t * raster.GROUP + r
            pairs[row] = rec
            pairs[row, 12] = row
    gpairs = np.tile(killed, (raster.GLOBAL_CAP, 1))
    gpairs[0] = record(cover, (0, 0, 0.75))
    gpairs[0, 12] = GLOBAL_ID
    i32 = torch.int32

    def binned_of(p: np.ndarray, g: np.ndarray, gcount: int):
        return raster.BinnedTriangles(
            pairs=torch.from_numpy(p),
            starts=torch.arange(nt + 1, dtype=i32) * raster.GROUP,
            rstarts=torch.full((BOUNDED_TILES + 1,), nt * raster.GROUP,
                               dtype=i32),
            gpairs=torch.from_numpy(g),
            gmeta=torch.tensor([gcount, BOUNDED_TILES], dtype=i32),
            overflow=torch.zeros(3, dtype=i32),
            demand=torch.tensor(nt * len(recs), dtype=i32),
            tiles_x=BOUNDED_TILES, tiles_y=BOUNDED_TILES, pair_cap=len(p))

    # the sloped record's depth at each pixel center, as the kernel
    # evaluates it
    sloped = np.tile(killed, (nt * raster.GROUP, 1))
    sloped[::raster.GROUP] = pairs[::raster.GROUP]
    s = raster.rasterize_gbuf_plain(
        binned_of(sloped, np.tile(killed, (raster.GLOBAL_CAP, 1)), 0),
        BOUNDED_W, BOUNDED_H)[0]
    inf = torch.tensor(float("inf"))
    named = {"S": s, "S-": torch.nextafter(s, -inf), "S+": torch.nextafter(s, inf)}
    y, x = torch.meshgrid(torch.arange(BOUNDED_H), torch.arange(BOUNDED_W),
                          indexing="ij")
    cls = (x + 5 * y) % len(BOUNDED_WINDOWS)
    zlo, zhi = torch.zeros_like(s), torch.zeros_like(s)
    for c, (lo, hi) in enumerate(BOUNDED_WINDOWS):
        sel = cls == c
        for img, v in ((zlo, lo), (zhi, hi)):
            img[sel] = (named[v] if isinstance(v, str)
                        else torch.full_like(s, v))[sel]
    dev = torch.device(device)
    binned = binned_of(pairs, gpairs, 1)
    binned = raster.BinnedTriangles(**{
        f: (getattr(binned, f).to(dev) if isinstance(getattr(binned, f), torch.Tensor)
            else getattr(binned, f)) for f in binned.__dataclass_fields__})
    return binned, (zlo.to(dev), zhi.to(dev)), cls.to(dev)


# ---------------------------------------------------------------------------
# K1's reject stream (all four variants): records on the reject margin
# ---------------------------------------------------------------------------

REJECT_TILES_X, REJECT_TILES_Y = 4, 2
REJECT_W = REJECT_TILES_X * raster.TILE_W - 12      # ragged, like a frame
REJECT_H = REJECT_TILES_Y * raster.TILE_H - 2
# the margin targets: (plane, value the mode's own test compares with)
# - "edge0": edge 0 at its maximum over a warp footprint near 0 (CENTER)
# - "thr": near the smallest of edge 0's MSAA thresholds (COVERAGE)
# - "z0": the depth plane's maximum near 0 (both modes)
# - "z1": its minimum near 1 (COVERAGE keeps z <= 1)
MARGIN_TARGETS = ("edge0", "thr", "z0", "z1")
MARGIN_PER_CASE = 3     # records per (target, side)
REACH_BIAS_SHARE = 0.25  # how far past the pixel centre a reach edge lies


def _plane_value(rec: torch.Tensor, p: int, x0: float, y0: float, lx: int,
                 ly: int) -> torch.Tensor:
    """Plane p of records rec [N, 12] at pixel (lx, ly) of the tile at
    (x0, y0), as the kernels evaluate it (split, edge bias) -> [N]."""
    return raster._plane_eval_split(
        rec[None], torch.tensor([x0]), torch.tensor([y0]),
        torch.tensor([2.0 * lx + 1.0]), torch.tensor([2.0 * ly + 1.0]))[p][0, :, 0]


def _straddle(a: float, b: float, p: int, x0: float, y0: float, lx: int,
              ly: int, theta: float, le: bool) -> dict:
    """The constant c of plane p = (a, b, c) whose value at pixel (lx, ly)
    lies nearest to theta on each side: {True: the nearest value the
    plane's test accepts (>= theta, or <= theta where le), False: the
    nearest it refuses} -> c per side."""
    gx, gy = x0 + lx + 0.5, y0 + ly + 0.5
    c0 = torch.tensor([theta - (a * gx + b * gy)], dtype=torch.float32)

    def value(c: torch.Tensor) -> torch.Tensor:
        rec = torch.zeros((c.shape[0], 12))
        rec[:, 3 * p], rec[:, 3 * p + 1], rec[:, 3 * p + 2] = a, b, c
        return _plane_value(rec, p, x0, y0, lx, ly)

    for _ in range(2):
        c0 = c0 + (theta - value(c0))
    steps = torch.arange(-32, 33, dtype=torch.float32)
    cands = torch.cat([c0 + steps * _ulp(c0) * 2.0 ** j for j in (0, 3, 6, 9, 12)])
    v = value(cands)
    ok = v <= theta if le else v >= theta
    out = {}
    for side in (True, False):
        sel = ok == side
        if not bool(sel.any()):
            raise RuntimeError(f"no {side} value of plane {p} near {theta}")
        gap = (v - theta).abs().double()
        gap[~sel] = float("inf")
        out[side] = float(cands[int(gap.argmin())])
    return out


def _triangle_edges(pts) -> list:
    """Three edges (a, b, c) of the triangle pts [(x, y)] x 3, edge i
    opposite vertex i, each >= 0 inside."""
    out = []
    for i in range(3):
        (xa, ya), (xb, yb) = pts[(i + 1) % 3], pts[(i + 2) % 3]
        e = np.array([ya - yb, xb - xa, xa * yb - xb * ya])
        if e[0] * pts[i][0] + e[1] * pts[i][1] + e[2] < 0:
            e = -e
        out.append(tuple(e))
    return out


def reject_probe(seed: int = 0, device: torch.device | str = "cpu"):
    """Crafted records on and around the margin of K1's reject test ->
    (BinnedTriangles of REJECT_W x REJECT_H pixels (4 x 2 tiles), (zlo,
    zhi) [H, W] a seeded depth window for the bounded variants, info).

    - Margin records, each at a random corner of its own warp footprint
      of tiles 0-5. Their target plane (MARGIN_TARGETS) takes, at the
      corner pixel, the value nearest its test's bound on one side
      (accepted or refused: MARGIN_PER_CASE records per target and side);
      elsewhere in the footprint it lies further outside. A small triangle
      keeps each record to a few pixels around its corner; the other planes
      accept there by about a pixel.
    - Neighbour-bin records: tiles 0-5's segments are packed into the
      first two groups, so every one of them streams all of them (the
      group rounding sweeps them in). Four records, each listed in one
      tile's segment, cover pixel centres of a neighbouring tile (0 -> 1,
      1 -> 0, 0 -> 4, 4 -> 0) only through the 2^-15 edge bias: their edge
      lies REACH_BIAS_SHARE of that tile's bias past the pixel centre.
    - Killed records inside the segments and as the groups' padding.
    - Tiles 6 and 7 (the third group, streamed by them alone): records of
      triangles with a vertex at w <= 0 (through setup_triangles and
      pack_records), a record whose edges are all zero (it covers
      everything, at z = 0.99), edges scaled by 1e25, 1e-30 and 1e-38, and
      a NaN and an infinite edge.

    info: "margin" [(row, target, accepted, corner pixel (x, y))], "reach" [(row, home tile,
    reached tile)], counts "killed", "near_plane", "degenerate". A
    record's id (row 12) is its row in the pair array."""
    rng = np.random.default_rng(seed)
    tw, th = raster.TILE_W, raster.TILE_H
    nt = REJECT_TILES_X * REJECT_TILES_Y
    killed = raster.killed_record(raster.GBUF_ROWS, torch.device("cpu")).numpy()
    segs = [[] for _ in range(nt)]
    info = {"margin": [], "reach": [], "killed": 0, "near_plane": 0,
            "degenerate": 0}

    def origin(t: int) -> tuple[float, float]:
        return float(t % REJECT_TILES_X * tw), float(t // REJECT_TILES_X * th)

    # margin records, one footprint each
    slots = [(t, f) for t in range(6) for f in range(8)]
    order = rng.permutation(len(slots))
    cases = [(g, side) for g in MARGIN_TARGETS for side in (True, False)
             ] * MARGIN_PER_CASE
    for (g, side), k in zip(cases, order):
        t, f = slots[k]
        x0, y0 = origin(t)
        (c0, c1), (r0, r1) = raster.footprints()[f]
        right, down = bool(rng.integers(2)), bool(rng.integers(2))
        lx, ly = (c1 if right else c0), (r1 if down else r0)
        q = np.array([x0 + lx + 0.5, y0 + ly + 0.5])
        sx, sy = (1.0 if right else -1.0), (1.0 if down else -1.0)
        if g in ("edge0", "thr"):
            # edge 0 rises towards the corner (its maximum there); the
            # triangle lies beyond it, its apex 3 pixels outwards
            a = float(np.float32(sx * rng.uniform(0.3, 2.0)))
            b = float(np.float32(sy * rng.uniform(0.3, 2.0)))
            theta = 0.0
            if g == "thr":
                ta, tb = torch.tensor([a]), torch.tensor([b])
                theta = min(float(raster.msaa_threshold(ta, tb, s, fused[i]))
                            for s in range(4) for i in (0,)
                            for fused in (raster.MSAA_COVERAGE_FUSED[s],
                                          raster.MSAA_KEY_FUSED[s]))
            c = _straddle(a, b, 0, x0, y0, lx, ly, theta, False)[side]
            n = np.array([a, b]) / np.hypot(a, b)
            tan = np.array([-n[1], n[0]])
            apex, bp, bm = q + 3 * n, q - 0.5 * n + 3 * tan, q - 0.5 * n - 3 * tan
            e = _triangle_edges([apex, bp, bm])
            edges = [(a, b, c), e[2], e[1]]       # opposite bm, bp
            plane = (0.0, 0.0, float(rng.uniform(0.2, 0.8)))
        else:
            # the depth plane's maximum (z0) or minimum (z1) over the
            # footprint at the corner; a triangle of radius 3 around it
            up = g == "z0"
            a = float(np.float32((sx if up else -sx) * rng.uniform(1e-3, 3e-3)))
            b = float(np.float32((sy if up else -sy) * rng.uniform(1e-3, 3e-3)))
            theta = 0.0 if up else 1.0
            c = _straddle(a, b, 3, x0, y0, lx, ly, theta, not up)[side]
            ang = rng.uniform(0, 2 * np.pi) + np.arange(3) * 2 * np.pi / 3
            edges = _triangle_edges([q + 3 * np.array([np.cos(u), np.sin(u)])
                                     for u in ang])
            plane = (a, b, c)
        segs[t].append(("margin", (g, side, (int(x0) + lx, int(y0) + ly)),
                        None, _attr_record(rng, edges, plane)))

    # neighbour-bin records reaching a pixel centre through the edge bias
    for home, reached, axis in ((1, 0, "x"), (0, 1, "x"), (4, 0, "y"),
                                (0, 4, "y")):
        x0, y0 = origin(reached)
        fwd = home > reached               # home lies right of / below
        n = np.array([1.0, 0.0]) if axis == "x" else np.array([0.0, 1.0])
        s = 1.0 if fwd else -1.0
        # the reached tile's last (first) pixel centre before the boundary
        if axis == "x":
            lx, ly = (tw - 1 if fwd else 0), int(rng.integers(2, th - 6))
        else:
            lx, ly = int(rng.integers(2, tw - 6)), (th - 1 if fwd else 0)
        q = np.array([x0 + lx + 0.5, y0 + ly + 0.5])
        # edge s * (n . p) >= s * (n . q) + delta, the reached tile's bias
        # folded at its origin
        ex2, ey2 = 0.5 * s * n
        ew2 = s * float(n @ (np.array([x0, y0]) - q))
        bias = (abs(ex2) * 2 * tw + abs(ey2) * 2 * th + abs(ew2)) * raster.EDGE_BIAS
        off = float(n @ q) + s * REACH_BIAS_SHARE * bias
        edge0 = (s * n[0], s * n[1], -s * off)
        tan = np.array([-n[1], n[0]])
        inner = q + s * n * 3.0
        e = _triangle_edges([inner, q - 0.5 * s * n + 3 * tan,
                             q - 0.5 * s * n - 3 * tan])
        rec = _attr_record(rng, [edge0, e[1], e[2]], (0.0, 0.0, 0.05))
        v = _plane_value(torch.from_numpy(rec[None, :12]), 0, x0, y0, lx, ly)
        if not float(v) >= 0.0:
            raise RuntimeError(f"reach record {home} -> {reached} misses ({float(v)})")
        segs[home].append(("reach", reached, None, rec))

    # killed records inside the segments
    for t in range(6):
        for _ in range(2):
            segs[t].insert(int(rng.integers(0, len(segs[t]) + 1)),
                           ("killed", None, None, killed.copy()))
            info["killed"] += 1

    # tiles 6 and 7: near-plane and degenerate records
    w_, h_ = REJECT_W, REJECT_H
    near = []
    while len(near) < 6:
        cc = rng.uniform(-1, 1, (16, 3, 4)).astype(np.float32)
        cc[:, :, 3] = rng.uniform(0.2, 2.0, (16, 3))
        cc[:, 0, 3] = rng.uniform(-1.0, 0.0, 16)      # a vertex at w <= 0
        cc[:, :, 0] *= 3 * np.abs(cc[:, :, 3])
        cc[:, :, 1] *= 3 * np.abs(cc[:, :, 3])
        cc[:, :, 2] = 0.5 * cc[:, :, 3] + 0.05
        setup = raster.setup_triangles(torch.from_numpy(cc), w_, h_)
        recs = raster.pack_records(setup, torch.zeros((16, 17)))
        near += [recs[i].numpy() for i in range(16) if bool(setup.valid[i])]
    degenerate = []
    zero = _attr_record(rng, [(0.0, 0.0, 0.0)] * 3, (0.0, 0.0, 0.99))
    degenerate.append(zero)
    for scale in (1e25, 1e-30, 1e-38):
        pts = [np.array([300.0, 18.0]), np.array([340.0, 18.0]),
               np.array([300.0, 29.0])]
        edges = [tuple(np.float32(np.array(e) * scale))
                 for e in _triangle_edges(pts)]
        degenerate.append(_attr_record(rng, edges, (0.0, 0.0, 0.3)))
    for bad in (float("nan"), float("inf")):
        degenerate.append(_attr_record(rng, [(bad, 0.0, 1.0), (0.0, 0.0, 1.0),
                                             (0.0, 0.0, 1.0)], (0.0, 0.0, 0.1)))
    for i, rec in enumerate(near[:6]):
        rec = rec.copy()
        rec[13:30] = _attr_record(rng, [(0, 0, 0)] * 3, (0, 0, 0))[13:30]
        segs[6 + i % 2].append(("near_plane", None, None, rec))
        info["near_plane"] += 1
    for i, rec in enumerate(degenerate):
        segs[6 + i % 2].append(("degenerate", None, None, rec))
        info["degenerate"] += 1

    # pack: tiles 0-5 from row 0 on, tiles 6-7 from the third group
    g = raster.GROUP
    n05 = sum(len(s) for s in segs[:6])
    n67 = sum(len(s) for s in segs[6:])
    if n05 > 2 * g or n67 > g:
        raise RuntimeError(f"reject probe overfull: {n05}, {n67}")
    cap = 4 * g
    pairs = np.tile(killed, (cap, 1))
    starts = np.zeros(nt + 1, np.int32)
    row = 0
    for t in range(nt):
        if t == 6:
            row = 2 * g
        starts[t] = row
        for kind, a1, a2, rec in segs[t]:
            rec = rec.copy()
            if kind != "killed":
                rec[12] = row
            pairs[row] = rec
            if kind == "margin":
                info["margin"].append((row, *a1))
            elif kind == "reach":
                info["reach"].append((row, t, a1))
            row += 1
    starts[nt] = row
    gpairs = np.tile(killed, (raster.GLOBAL_CAP, 1))
    dev = torch.device(device)
    i32 = dict(dtype=torch.int32, device=dev)
    binned = raster.BinnedTriangles(
        pairs=torch.from_numpy(pairs).to(dev),
        starts=torch.from_numpy(starts).to(dev),
        rstarts=torch.full((REJECT_TILES_Y + 1,), cap, **i32),
        gpairs=torch.from_numpy(gpairs).to(dev),
        gmeta=torch.tensor([0, REJECT_TILES_X], **i32),
        overflow=torch.zeros(3, **i32),
        demand=torch.tensor(int(row), **i32),
        tiles_x=REJECT_TILES_X, tiles_y=REJECT_TILES_Y, pair_cap=cap)
    u = torch.from_numpy(rng.uniform(0, 1, (2, REJECT_H, REJECT_W)))
    zlo = torch.where(u[0] < 0.5, -1.0, 0.1).float().to(dev)
    zhi = torch.where(u[1] < 0.5, 2.0, 0.9).float().to(dev)
    return binned, (zlo, zhi), info


def vis_records(binned: raster.BinnedTriangles) -> raster.BinnedTriangles:
    """K1's 32-row records cut to K2's 16 rows (the 12 plane floats and the
    id lead both layouts), the rest of the binning as it is."""
    return raster.BinnedTriangles(**{
        **{f: getattr(binned, f) for f in binned.__dataclass_fields__},
        "pairs": binned.pairs[:, :raster.PAIR_ROWS].contiguous(),
        "gpairs": binned.gpairs[:, :raster.PAIR_ROWS].contiguous()})


# ---------------------------------------------------------------------------
# K2's occlusion reject: records stacked on a footprint's depth
# ---------------------------------------------------------------------------

DEPTH_TILES_X = 2
DEPTH_W = DEPTH_TILES_X * raster.TILE_W - 5           # ragged, like a frame
DEPTH_H = raster.TILE_H - 1
DEPTH_Z = 0.5                 # the occluder's depth, exact in the split
DEPTH_M = DEPTH_Z * raster.REJECT_REL   # the margin of a flat plane there


def _flat(z: float) -> tuple:
    return (0.0, 0.0, z)


def depth_reject_probe(device: torch.device | str = "cpu"):
    """Crafted 16-row records on and around the occlusion reject's margin
    -> (BinnedTriangles of DEPTH_W x DEPTH_H pixels (2 tiles), info).

    Tile 0 streams an occluder covering columns 0-63 at z = 0.5 (alone in
    the stream's first batch of raster.BATCH records, the rest killed, so
    that its depths are in place before the next batch is tested), then,
    in the next batch,
    records over the same columns at z = 0.5 (a tie), one f32 ulp above
    it, M / 2 above it (inside the margin M of a flat plane there) and 2M
    above it, the last one over the whole tile: hidden in footprints 0, 1,
    4 and 5 and visible in the others; then a record one ulp below 0.5 on
    columns 8-15 (it wins there), two sloped records over footprint 1
    whose depth at its corner pixel (32, 0) is the float just below 0.5
    (it wins that pixel alone) and 0.5 itself (a tie there), and a record
    at 1 - 2^-24 over the whole tile, hidden everywhere. Tile 1 has no
    occluder, so its carries are the cleared 1.0: a record at 1 + 4M over
    the tile (hidden), one at z = 1 (never below the carry), one at
    1 - 2^-24 on columns 0-63 and one at 1 - M on columns 64-127 (both
    win), and one with a NaN depth plane (never rejected, never wins).
    Every flat depth is exact in the kernels' split arithmetic.

    info: "rows" {name: row}; "winners" {name: pixel count it must win};
    "occluded": the (record, footprint) pairs the mirror's occlusion
    reject drops (raster.reject_stream_counts)."""
    g = raster.GROUP
    rows = raster.PAIR_ROWS
    killed = raster.killed_record(rows, torch.device("cpu")).numpy()
    tw = float(raster.TILE_W)
    whole = [(0.0, 0.0, 1.0)] * 3

    def cols(lo: float, hi: float) -> list:
        # pixel centres lo + 0.5 .. hi - 0.5 of the frame's columns
        return [(1.0, 0.0, -lo), (-1.0, 0.0, hi), (0.0, 0.0, 1.0)]

    ulp_below = float(np.nextafter(np.float32(DEPTH_Z), np.float32(0)))
    ulp_above = float(np.nextafter(np.float32(DEPTH_Z), np.float32(1)))
    one_below = float(np.nextafter(np.float32(1.0), np.float32(0)))
    m1 = raster.REJECT_REL    # the margin of a flat plane at z = 1
    # sloped over footprint 1, rising away from its corner pixel (32, 0):
    # slopes exact in bf16, whose products there add up to 2^-5 exactly,
    # and a constant whose bf16 hi part is 0.5 - 2^-5; the lo part then
    # sets the corner's depth to the float: 0.5 - 2^-25 or 0.5
    a, b = 2.0 ** -11, 63 * 2.0 ** -11
    c_tie = DEPTH_Z - 2.0 ** -5
    tile0 = [
        ("occluder", cols(0, 64), _flat(DEPTH_Z)),
        ("tie", cols(0, 64), _flat(DEPTH_Z)),
        ("ulp_above", cols(0, 64), _flat(ulp_above)),
        ("inside_margin", cols(0, 64), _flat(DEPTH_Z + DEPTH_M / 2)),
        ("beyond_margin", whole, _flat(DEPTH_Z + 2 * DEPTH_M)),
        ("ulp_below", cols(8, 16), _flat(ulp_below)),
        ("sloped_below", cols(32, 64), (a, b, c_tie - 2.0 ** -25)),
        ("sloped_tie", cols(32, 64), (a, b, c_tie)),
        ("hidden", whole, _flat(one_below)),
    ]
    tile1 = [
        ("clear_beyond", whole, _flat(1.0 + 4 * m1)),
        ("clear_tie", whole, _flat(1.0)),
        ("clear_ulp_below", cols(tw, tw + 64), _flat(one_below)),
        ("clear_inside", cols(tw + 64, 2 * tw), _flat(1.0 - m1)),
        ("nan", whole, _flat(float("nan"))),
    ]
    pairs = np.tile(killed, (4 * g, 1))
    info = {"rows": {}}
    row = 0
    starts = [0]
    for t, recs in enumerate((tile0, tile1)):
        for k, (name, edges, plane) in enumerate(recs):
            pairs[row, 0:9] = np.asarray(edges, np.float32).reshape(-1)
            pairs[row, 9:12] = plane
            pairs[row, 12] = row
            info["rows"][name] = row
            # tile 0's occluder alone in its batch of 2 groups
            row = row + 1 if (t or k) else 2 * g
        if t == 0:
            row = max(row, 3 * g)
            starts.append(row)
    starts.append(row)
    # pixels each record wins (frame columns < DEPTH_W, rows < DEPTH_H)
    h = DEPTH_H
    info["winners"] = {
        "occluder": 64 * h - 8 * h - 1, "beyond_margin": 64 * h,
        "ulp_below": 8 * h, "sloped_below": 1,
        "clear_ulp_below": 64 * h, "clear_inside": (DEPTH_W - 192) * h}
    info["occluded"] = {"beyond_margin": (0, 1, 4, 5), "hidden": (0, 1, 4, 5),
                        "sloped_below": (5,), "sloped_tie": (5,),
                        "clear_beyond": tuple(range(8))}
    dev = torch.device(device)
    i32 = dict(dtype=torch.int32, device=dev)
    binned = raster.BinnedTriangles(
        pairs=torch.from_numpy(pairs).to(dev),
        starts=torch.tensor(starts, **i32),
        rstarts=torch.full((2,), 4 * g, **i32),
        gpairs=torch.from_numpy(np.tile(killed, (raster.GLOBAL_CAP, 1))).to(dev),
        gmeta=torch.tensor([0, DEPTH_TILES_X], **i32),
        overflow=torch.zeros(3, **i32),
        demand=torch.tensor(len(tile0) + len(tile1), **i32),
        tiles_x=DEPTH_TILES_X, tiles_y=1, pair_cap=4 * g)
    return binned, info
