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
        rec = np.zeros(rows, np.float32)
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
