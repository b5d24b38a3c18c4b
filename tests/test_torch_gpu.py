"""The port's CUDA kernels against their plain PyTorch versions on a card.

Marked gpu; every test skips without a CUDA card. On a machine with a card
(and no jax, so without the JAX suite's conftest):

    python -m pytest --noconftest tests/test_torch_gpu.py -q
"""
import pytest
import torch

from vqengine_tpu_torch.engine.scene_load import SPONZA_TRANSLUCENT, load_scene
from vqengine_tpu_torch.entry import HEIGHT, WIDTH, entry
from vqengine_tpu_torch.ops import (_backend, palette, raster, raster_probes,
                                    shadow)
from vqengine_tpu_torch.render import graph
from vqengine_tpu_torch.render.renderer import VQRendererTorch

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _backend.library()          # builds the kernels on first use
    return torch.device("cuda")


def bitwise(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


# K in {2, 9, 16, 17, 32}: the vectorised path (K % 4 == 0) and the
# flattened one, whose n * K % 4 tail is 1 or 2 here; the last three tables
# (512, 106 and 100 KB) are too large for shared memory (read through
# __ldg)
@pytest.mark.parametrize("m,k", [(7, 32), (85, 16), (85, 9), (85, 2), (3, 17),
                                 (4000, 32), (3000, 9), (1500, 17)])
def test_palette_kernel_bitwise(cuda, m, k):
    g = torch.Generator().manual_seed(m * k)
    mp = palette.padded_rows(m)
    idx = torch.randint(-5, mp + 5, (333, 517), generator=g,
                        dtype=torch.int32).to(cuda)
    table = torch.randn(m, k, generator=g).to(cuda)
    before = _backend.launches["palette"]
    out = palette.palette_lookup(idx, table)
    assert _backend.launches["palette"] == before + 1
    assert bitwise(out, palette.palette_lookup_plain(idx, table))


@pytest.mark.parametrize("k", [2, 9, 16, 17, 32])
@pytest.mark.parametrize("n", [0, 1, 2, 3, 5, 7])
def test_palette_kernel_small(cuda, n, k):
    """n ids, none to a few segments: only the tail, or a segment and a
    tail (K = 2, 9, 17), ids below 0, in [M, mp) and past mp."""
    idx = torch.tensor([-4, 11, 5, 20, 0, 7, 3][:n], dtype=torch.int32,
                       device=cuda)
    table = torch.randn(11, k, generator=torch.Generator().manual_seed(k)).to(cuda)
    out = palette.palette_lookup(idx, table)
    assert tuple(out.shape) == (n, k)
    assert bitwise(out, palette.palette_lookup_plain(idx, table))


def test_raster_gbuf_kernel_bitwise(cuda):
    _, (scene, consts) = entry(cuda)
    setup, extra = graph.geometry_setup_gbuf(scene, consts, WIDTH, HEIGHT)
    binned = raster.bin_triangles(setup, WIDTH, HEIGHT, extra=extra)
    d, i, g = raster.rasterize_gbuf(binned, WIDTH, HEIGHT)
    d2, i2, g2 = raster.rasterize_gbuf_plain(binned, WIDTH, HEIGHT)
    assert bitwise(i, i2) and bitwise(d, d2) and bitwise(g, g2)
    assert float((i >= 0).float().mean()) > 0.1


def test_entry_on_card_matches_cpu(cuda):
    """ldr within 3e-4 (the reference's multichip bar): the front end and
    shading run as torch ops on both devices; the card's scalar divisions
    may round differently."""
    fn, args = entry(cuda)
    fn_c, args_c = entry(torch.device("cpu"))
    assert float((fn(*args).cpu() - fn_c(*args_c)).abs().max()) <= 3e-4


def test_wrappers_reject_bad_inputs(cuda):
    table = torch.randn(4, 8, device=cuda)
    with pytest.raises(ValueError):
        palette.palette_lookup(torch.zeros(5, dtype=torch.int64, device=cuda),
                               table)
    with pytest.raises(ValueError):
        palette.palette_lookup(torch.zeros(5, dtype=torch.int32, device=cuda),
                               table.t())
    # n * K = 2^31 outputs: past the kernel's 32-bit indexing
    with pytest.raises(ValueError):
        palette.palette_lookup(torch.empty(2 ** 28, dtype=torch.int32,
                                           device=cuda), table)


@pytest.fixture(scope="module")
def sponza_card(cuda):
    s = load_scene("Sponza", 128, 64)
    r = VQRendererTorch(cuda)
    r.load_scene(s.buffers)
    return s, r, r.build_frame_constants(s.buffers, s.cameras[0], s.lights)


@pytest.mark.parametrize("view,size", [("spot", 256), ("point", 256),
                                       ("dir", 512)])
def test_raster_vis_kernel_bitwise(sponza_card, view, size):
    """K2 against its plain version on Sponza caster views (a point face
    crosses the near plane)."""
    _, r, c = sponza_card
    vp = {"spot": c.spot_caster_vps[0], "point": c.point_caster_vps[0, 1],
          "dir": c.dir_vp[0]}[view]
    sc = r.scene
    binned = shadow.bin_shadow_view(sc.positions, sc.item_of_vertex, c.world,
                                    vp, sc.indices, size)
    before = _backend.launches["raster_vis"]
    d, i = raster.rasterize(binned, size, size)
    assert _backend.launches["raster_vis"] == before + 1
    d2, i2 = raster.rasterize_plain(binned, size, size)
    assert bitwise(d, d2) and bitwise(i, i2)
    assert float((i >= 0).float().mean()) > 0.2


def test_shadowed_frame_on_card_matches_cpu(sponza_card):
    """Sponza with ESM maps rendered in the frame (8 K2 launches): ldr
    within 3e-4 of the CPU where tri_id agrees (>= 99.9% of pixels)."""
    s, r, c = sponza_card
    before = _backend.launches["raster_vis"]
    out = r.render(c, 128, 64, shadow_dims=(64, 64, 64))
    assert _backend.launches["raster_vis"] == before + 8
    rc = VQRendererTorch(torch.device("cpu"))
    rc.load_scene(s.buffers)
    ref = rc.render(rc.build_frame_constants(s.buffers, s.cameras[0], s.lights),
                    128, 64, shadow_dims=(64, 64, 64))
    same = out["tri_id"].cpu() == ref["tri_id"]
    assert float(same.float().mean()) >= 0.999
    assert float((out["ldr"].cpu() - ref["ldr"])[same].abs().max()) <= 3e-4


@pytest.mark.parametrize("msaa", [False, True])
def test_rasterize_rejects_gbuf_records(cuda, msaa):
    """K2 takes 16-row records only; K1's 32-row records raise, and K1
    rejects K2's."""
    _, (scene, consts) = entry(cuda)
    setup, extra = graph.geometry_setup_gbuf(scene, consts, WIDTH, HEIGHT)
    binned = raster.bin_triangles(setup, WIDTH, HEIGHT, extra=extra)
    with pytest.raises(ValueError):
        raster.rasterize(binned, WIDTH, HEIGHT, msaa=msaa)
    vis = raster.bin_triangles(setup, WIDTH, HEIGHT)
    with pytest.raises(ValueError):
        raster.rasterize_gbuf(vis, WIDTH, HEIGHT, msaa=msaa)


def test_raster_gbuf_msaa_kernel_bitwise(sponza_card):
    """K1-MSAA against its plain version on the binned Sponza frame:
    depth, tri_id, G-buffer and per-sample coverage bitwise (a closed
    interior: every sample is covered; the silhouettes are
    test_raster_gbuf_msaa_kernel_silhouettes')."""
    _, r, c = sponza_card
    setup, extra = graph.geometry_setup_gbuf(r.scene, c, 128, 64)
    binned = raster.bin_triangles(setup, 128, 64, extra=extra)
    before = _backend.launches["raster_gbuf_msaa"]
    out = raster.rasterize_gbuf(binned, 128, 64, msaa=True)
    assert _backend.launches["raster_gbuf_msaa"] == before + 1
    plain = raster.rasterize_gbuf_plain(binned, 128, 64, msaa=True)
    for a, b in zip(out, plain):
        assert bitwise(a, b)
    assert bool(((out[3] == 0) | (out[3] == 1)).all())


def _msaa_kernel_vs_plain(binned, width, height):
    """K1-MSAA and its plain version on binned, bitwise -> (kernel outputs,
    partly covered pixels, sample-only winners: pixels K1-MSAA gives a
    winner and the center-sampled K1 none)."""
    before = _backend.launches["raster_gbuf_msaa"]
    out = raster.rasterize_gbuf(binned, width, height, msaa=True)
    assert _backend.launches["raster_gbuf_msaa"] == before + 1
    plain = raster.rasterize_gbuf_plain(binned, width, height, msaa=True)
    for a, b in zip(out, plain):
        assert bitwise(a, b)
    _, center, _ = raster.rasterize_gbuf(binned, width, height)
    n = out[3].sum(0)
    return (out, int(((n > 0) & (n < 4)).sum()),
            int(((out[1] >= 0) & (center < 0)).sum()))


def test_raster_gbuf_msaa_kernel_silhouettes(cuda):
    """K1-MSAA against its plain version on HelloCube at 192x108, whose
    silhouettes have partly covered pixels and pixels that only a sample
    covers (key z + 1): depth, tri_id, G-buffer and coverage bitwise."""
    s = load_scene("HelloCube", 192, 108)
    r = VQRendererTorch(cuda)
    r.load_scene(s.buffers)
    c = r.build_frame_constants(s.buffers, s.cameras[0], s.lights)
    setup, extra = graph.geometry_setup_gbuf(r.scene, c, 192, 108)
    binned = raster.bin_triangles(setup, 192, 108, extra=extra)
    _, part, sample_only = _msaa_kernel_vs_plain(binned, 192, 108)
    assert part > 0 and sample_only > 0


def test_raster_gbuf_msaa_kernel_probe(cuda):
    """K1-MSAA against its plain version on ops/raster_probes.py's crafted
    records (per-sample thresholds decided by their rounding, for the
    coverage bits and the depth key; the key select; z = 1; records past
    the counts): bitwise, each case reached."""
    pb, counts = raster_probes.msaa_probe(device=cuda)
    (depth, tri_id, _, cov), _, sample_only = _msaa_kernel_vs_plain(
        pb, raster_probes.WIDTH, raster_probes.HEIGHT)
    one = int(((cov.sum(0) == 1) & (tri_id >= 0)).sum())
    assert one >= counts["thresholds"] // 4 and sample_only > 0
    assert int(((depth == 0) & (tri_id >= 0)).sum()) == counts["z1"]


@pytest.mark.parametrize("view,size", [("spot", 256), ("dir", 512)])
def test_raster_vis_msaa4_kernel_bitwise(sponza_card, view, size):
    """K2-msaa4 against its plain version on Sponza caster views: the
    per-sample depth and tri_id stacks bitwise."""
    _, r, c = sponza_card
    vp = {"spot": c.spot_caster_vps[0], "dir": c.dir_vp[0]}[view]
    sc = r.scene
    binned = shadow.bin_shadow_view(sc.positions, sc.item_of_vertex, c.world,
                                    vp, sc.indices, size)
    before = _backend.launches["raster_vis_msaa4"]
    d, i = raster.rasterize(binned, size, size, msaa=True)
    assert _backend.launches["raster_vis_msaa4"] == before + 1
    d2, i2 = raster.rasterize_plain(binned, size, size, msaa=True)
    assert tuple(d.shape) == (4, size, size)
    assert bitwise(d, d2) and bitwise(i, i2)
    assert bool((i != i[:1]).any())


@pytest.mark.parametrize("msaa", [False, True])
def test_raster_vis_kernel_all_views(sponza_card, msaa):
    """K2 (both sample modes) against its plain version on all 8 Sponza
    caster views at a quarter of their sizes (spot and point faces 256^2,
    directional 512^2)."""
    _, r, c = sponza_card
    sc = r.scene
    views = ([(c.spot_caster_vps[0], 256), (c.dir_vp[0], 512)]
             + [(c.point_caster_vps[0, f], 256) for f in range(6)])
    for vp, size in views:
        binned = shadow.bin_shadow_view(sc.positions, sc.item_of_vertex,
                                        c.world, vp, sc.indices, size)
        d, i = raster.rasterize(binned, size, size, msaa=msaa)
        d2, i2 = raster.rasterize_plain(binned, size, size, msaa=msaa)
        assert bitwise(d, d2) and bitwise(i, i2)


@pytest.mark.parametrize("msaa", [False, True])
def test_raster_vis_kernel_depth_reject_probe(cuda, msaa):
    """K2 against its plain version on raster_probes.depth_reject_probe
    (records stacked on a footprint's depth, one ulp and within the margin
    of it, hidden in one footprint and visible in the next, the cleared
    carry 1.0, a NaN depth): bitwise, and in the center mode each record
    wins its pixels."""
    pb, info = raster_probes.depth_reject_probe(device=cuda)
    w, h = raster_probes.DEPTH_W, raster_probes.DEPTH_H
    name = "raster_vis_msaa4" if msaa else "raster_vis"
    before = _backend.launches[name]
    d, i = raster.rasterize(pb, w, h, msaa=msaa)
    assert _backend.launches[name] == before + 1
    d2, i2 = raster.rasterize_plain(pb, w, h, msaa=msaa)
    assert bitwise(d, d2) and bitwise(i, i2)
    if not msaa:
        for rec, row in info["rows"].items():
            assert int((i == row).sum()) == info["winners"].get(rec, 0), rec


@pytest.mark.parametrize("msaa", [False, True])
def test_raster_vis_kernel_reject_probe(cuda, msaa):
    """K2 (both sample modes) against its plain version on
    raster_probes.reject_probe's records cut to 16 rows: bitwise."""
    pb, _, _ = raster_probes.reject_probe(device=cuda)
    pb = raster_probes.vis_records(pb)
    w, h = raster_probes.REJECT_W, raster_probes.REJECT_H
    d, i = raster.rasterize(pb, w, h, msaa=msaa)
    d2, i2 = raster.rasterize_plain(pb, w, h, msaa=msaa)
    assert bitwise(d, d2) and bitwise(i, i2)
    assert int((i >= 0).sum()) > 0


@pytest.mark.parametrize("mode", ["neighbor", "shade"])
def test_msaa_frame_on_card_matches_cpu(cuda, mode):
    """Sponza at 192x108 with MSAA and 64^2 ESM maps rendered in the frame,
    in both edge-resolve modes: ldr within 3e-4 of the CPU where tri_id
    agrees (>= 99.9% of pixels), the same edge saturation."""
    s = load_scene("Sponza", 192, 108)
    outs = []
    for d in (cuda, torch.device("cpu")):
        r = VQRendererTorch(d)
        r.load_scene(s.buffers)
        c = r.build_frame_constants(s.buffers, s.cameras[0], s.lights)
        outs.append(r.render(c, 192, 108, shadow_dims=(64, 64, 64), msaa=True,
                             msaa_edge_resolve=mode))
    out, ref = outs
    same = out["tri_id"].cpu() == ref["tri_id"]
    assert float(same.float().mean()) >= 0.999
    assert float((out["ldr"].cpu() - ref["ldr"])[same].abs().max()) <= 3e-4
    assert float(out["saturation"]["msaa_edges"]) == float(
        ref["saturation"]["msaa_edges"])


def _bounded_vs_plain(binned, width, height, msaa, zbound):
    """K1-bounded and its plain version on one input, bitwise -> the
    kernel's outputs."""
    name = raster.gbuf_kernel_name(msaa, True)
    before = _backend.launches[name]
    out = raster.rasterize_gbuf(binned, width, height, msaa=msaa, zbound=zbound)
    assert _backend.launches[name] == before + 1
    plain = raster.rasterize_gbuf_plain(binned, width, height, msaa=msaa,
                                        zbound=zbound)
    for a, b in zip(out, plain):
        assert bitwise(a, b)
    return out


@pytest.mark.parametrize("msaa", [False, True])
def test_raster_gbuf_bounded_kernel_sponza(cuda, msaa):
    """K1-bounded against its plain version on Sponza at 128x64: the
    translucent Sponza's two peel windows (in front of the MSAA opaque
    depth), and an alpha-peel window (zlo = depth where a seeded mask
    fails, else 2; zhi = 2) on the opaque Sponza's binning."""
    w, h = 128, 64
    s = load_scene("Sponza", w, h, material_alpha=SPONZA_TRANSLUCENT)
    r = VQRendererTorch(cuda)
    r.load_scene(s.buffers)
    c = r.build_frame_constants(s.buffers, s.cameras[0], s.lights)
    opaque = graph.geometry_pass(r.scene, c, w, h, msaa=True)[0]
    setup, extra = graph.geometry_setup_gbuf(r.scene_t, c, w, h)
    binned = raster.bin_triangles(setup, w, h, extra=extra)
    zlo = torch.full_like(opaque, -1.0)
    for _ in range(2):
        out = _bounded_vs_plain(binned, w, h, msaa, (zlo, opaque))
        assert int((out[1] >= 0).sum()) > 0
        zlo = out[0]
    full = load_scene("Sponza", w, h)
    r.load_scene(full.buffers)
    assert r.scene_t is None
    c = r.build_frame_constants(full.buffers, full.cameras[0], full.lights)
    setup, extra = graph.geometry_setup_gbuf(r.scene, c, w, h)
    binned = raster.bin_triangles(setup, w, h, extra=extra)
    depth, tri_id, _ = raster.rasterize_gbuf(binned, w, h)
    fail = (torch.rand((h, w), generator=torch.Generator().manual_seed(4))
            < 0.3).to(cuda) & (tri_id >= 0)
    two = torch.full_like(depth, 2.0)
    out = _bounded_vs_plain(binned, w, h, msaa,
                            (torch.where(fail, depth, two), two))
    assert int((fail & (out[1] >= 0)).sum()) > 0


def test_raster_gbuf_msaa_bounded_kernel_silhouettes(cuda):
    """K1-MSAA-bounded against its plain version on HelloCube at 192x108
    with a window through the cube (its covered depths' quartiles):
    partly covered pixels inside the window."""
    s = load_scene("HelloCube", 192, 108)
    r = VQRendererTorch(cuda)
    r.load_scene(s.buffers)
    c = r.build_frame_constants(s.buffers, s.cameras[0], s.lights)
    setup, extra = graph.geometry_setup_gbuf(r.scene, c, 192, 108)
    binned = raster.bin_triangles(setup, 192, 108, extra=extra)
    depth, tri_id, _ = raster.rasterize_gbuf(binned, 192, 108)
    q = torch.quantile(depth[tri_id >= 0], torch.tensor([0.25, 0.75],
                                                        device=cuda))
    zbound = (torch.full_like(depth, float(q[0])), torch.full_like(depth, float(q[1])))
    out = _bounded_vs_plain(binned, 192, 108, True, zbound)
    n = out[3].sum(0)
    assert int(((n > 0) & (n < 4)).sum()) > 0
    assert int(((out[1] >= 0) & (out[1] != tri_id)).sum()) + int(
        ((out[1] < 0) & (tri_id >= 0)).sum()) > 0


@pytest.mark.parametrize("msaa", [False, True])
def test_raster_gbuf_bounded_kernel_probe(cuda, msaa):
    """K1-bounded against its plain version on
    ops/raster_probes.bounded_probe (fragments on zlo and zhi, empty
    windows, ties, sample-only fragments cut by the window, a ragged
    frame): bitwise."""
    pb, zbound, cls = raster_probes.bounded_probe(device=cuda)
    out = _bounded_vs_plain(pb, raster_probes.BOUNDED_W,
                            raster_probes.BOUNDED_H, msaa, zbound)
    assert bool((out[1][(cls == 7) | (cls == 10)] < 0).all())


def test_rasterize_gbuf_rejects_bad_zbound(cuda):
    """The window must be two contiguous [H, W] f32 tensors on the
    records' device."""
    _, (scene, consts) = entry(cuda)
    setup, extra = graph.geometry_setup_gbuf(scene, consts, WIDTH, HEIGHT)
    binned = raster.bin_triangles(setup, WIDTH, HEIGHT, extra=extra)
    z = torch.zeros((HEIGHT, WIDTH), device=cuda)
    for bad in [(z.double(), z), (z.cpu(), z), (z, z[:, :-1]), (z.t(), z),
                (z,)]:
        with pytest.raises(ValueError):
            raster.rasterize_gbuf(binned, WIDTH, HEIGHT, zbound=bad)


def test_transparent_frame_on_card_matches_cpu(cuda):
    """The translucent Sponza at 192x108, engine default (MSAA, neighbor
    edge resolve, cached 64^2 ESM maps), with its transparent pass (2
    K1-bounded launches): tri_id equal, ldr within 3e-4 of the CPU."""
    s = load_scene("Sponza", 192, 108, material_alpha=SPONZA_TRANSLUCENT)
    outs = []
    for d in (cuda, torch.device("cpu")):
        r = VQRendererTorch(d)
        r.load_scene(s.buffers)
        c = r.build_frame_constants(s.buffers, s.cameras[0], s.lights)
        maps = r.precompute_shadow_maps(c, (64, 64, 64))
        before = _backend.launches["raster_gbuf_bounded"]
        outs.append(r.render(c, 192, 108, shadow_dims=(64, 64, 64),
                             shadow_maps=maps, msaa=True))
        if d.type == "cuda":
            assert _backend.launches["raster_gbuf_bounded"] == before + 2
    out, ref = outs
    assert torch.equal(out["tri_id"].cpu(), ref["tri_id"])
    assert float((out["ldr"].cpu() - ref["ldr"]).abs().max()) <= 3e-4


@pytest.mark.parametrize("bounded", [False, True])
@pytest.mark.parametrize("msaa", [False, True])
def test_raster_gbuf_kernel_reject_probe(cuda, msaa, bounded):
    """Every K1 variant against its plain version on
    ops/raster_probes.reject_probe (records on the reject test's margin,
    neighbour-bin records reaching a tile through the edge bias, killed,
    near-plane and degenerate records; the bounded variants with the
    probe's window): bitwise, and the reach records win pixels of the tile
    they are not listed in."""
    pb, zbound, info = raster_probes.reject_probe(device=cuda)
    w, h = raster_probes.REJECT_W, raster_probes.REJECT_H
    kw = dict(msaa=msaa, zbound=zbound if bounded else None)
    name = raster.gbuf_kernel_name(msaa, bounded)
    before = _backend.launches[name]
    out = raster.rasterize_gbuf(pb, w, h, **kw)
    assert _backend.launches[name] == before + 1
    plain = raster.rasterize_gbuf_plain(pb, w, h, **kw)
    for a, b in zip(out, plain):
        assert bitwise(a, b)
    tile = ((torch.arange(h, device=cuda)[:, None] // raster.TILE_H)
            * raster_probes.REJECT_TILES_X
            + torch.arange(w, device=cuda)[None, :] // raster.TILE_W)
    reach = sum(int(((out[1] == row) & (tile == t)).sum())
                for row, _, t in info["reach"])
    assert bounded or reach > 0


@pytest.fixture(scope="module")
def env_cpu():
    """Sponza's environment (its ProceduralSky, decoded on the host) built
    on the CPU at the engine's default sizes."""
    s = load_scene("Sponza", 64, 32)
    return s.equirect, graph.build_environment(s.equirect, torch.device("cpu"))


def test_environment_build_on_card_matches_cpu(cuda, env_cpu):
    """build_environment on the card against the CPU's build of the same
    equirect (graph.environment_differences): bf16 tables within one bf16
    ulp on at most 1% of entries, the f32 tables within their normwise
    bars; the equirect itself bitwise."""
    equirect, ref = env_cpu
    env = graph.build_environment(equirect, cuda)
    assert env.equirect.is_cuda and env.specular_mips[1].is_cuda
    d = graph.environment_differences(env, ref)
    assert d["ok"], d
    assert d["equirect"][0] == 0


ENV_FRAMES = {"envmap": ("EnvironmentMapUnitTest", None, {}),
              "envmap_msaa_shade": ("EnvironmentMapUnitTest", None,
                                    dict(msaa=True, msaa_edge_resolve="shade")),
              "translucent_sponza": ("Sponza", SPONZA_TRANSLUCENT,
                                     dict(msaa=True, shadow_dims=(64, 64, 64)))}


@pytest.mark.parametrize("frame", sorted(ENV_FRAMES))
def test_env_frame_on_card_matches_cpu(cuda, env_cpu, frame):
    """Frames lit by the environment at 192x108, the CPU's tables carried
    to the card (EnvironmentMaps.to): EnvironmentMapUnitTest without MSAA
    and with the "shade" edge resolve, and the translucent Sponza (engine
    default, its transparent pass lit too): tri_id equal, ldr within
    3e-4 of the CPU."""
    name, alpha, flags = ENV_FRAMES[frame]
    s = load_scene(name, 192, 108, material_alpha=alpha)
    outs = []
    for d in (cuda, torch.device("cpu")):
        r = VQRendererTorch(d)
        r.load_scene(s.buffers)
        c = r.build_frame_constants(s.buffers, s.cameras[0], s.lights)
        outs.append(r.render(c, 192, 108, env=env_cpu[1].to(d), **flags))
    out, ref = outs
    assert torch.equal(out["tri_id"].cpu(), ref["tri_id"])
    assert float((out["ldr"].cpu() - ref["ldr"]).abs().max()) <= 3e-4


# the engine's default passes, card vs CPU: the AO's blur and upsample
# weights go through exp, which the card rounds otherwise; the palette
# path's 4x4 inverse (cuSOLVER vs LAPACK); the SSR history carries both
AO_TOL, MOTION_TOL, HIST_TOL = 1e-5, 2e-5, 1e-4


def _record_selections(rec: dict):
    """Wrap ssao._gather / ssr._gather and ssr.trace_reflections so that
    every pyramid fetch index and every trace's final texels (a trace of a
    colour holding each pixel's index) land in rec; -> the restore."""
    from vqengine_tpu_torch.ops import ssao, ssr
    saved = (ssao._gather, ssr._gather, ssr.trace_reflections)
    gather, trace = saved[0], saved[2]

    def g(flat, idx):
        rec.setdefault("fetch", []).append(idx.cpu())
        return gather(flat, idx)

    def t(color, *a, **k):
        h, w = color.shape[:2]
        enc = torch.zeros_like(color)
        enc[..., 0] = torch.arange(h * w, dtype=torch.float32,
                                   device=color.device).reshape(h, w)
        rec.setdefault("texel", []).append(trace(enc, *a, **k)[0][..., 0].cpu())
        return trace(color, *a, **k)
    ssao._gather = ssr._gather = g
    ssr.trace_reflections = t

    def restore():
        ssao._gather, ssr._gather, ssr.trace_reflections = saved
    return restore


@pytest.mark.parametrize("ids", [(), None], ids=["static", "palette"])
def test_engine_default_frames_on_card_match_cpu(cuda, env_cpu, ids):
    """The engine's default flags (MSAA, SSAO "medium", motion vectors, SSR)
    on the Default scene at 192x108 with the CPU's environment tables and
    cached 64^2 ESM maps, two frames whose camera turns and whose SSR
    history carries, motion on the
    static and on the palette path (one more K3 launch a frame): every
    pyramid fetch and SSR hit texel equal to the CPU's, ldr within 3e-4,
    ao, motion and ssr_history within their bars."""
    from vqengine_tpu_torch.engine.settings import FGraphicsSettings, render_flags
    s = load_scene("Default", 192, 108)
    flags = dict(render_flags(FGraphicsSettings()), dynamic_item_ids=ids,
                 shadow_dims=(64, 64, 64))
    cam = s.cameras[0]
    sides = []
    for d in (cuda, torch.device("cpu")):
        r = VQRendererTorch(d)
        r.load_scene(s.buffers)
        r.env = env_cpu[1].to(d)
        c = r.build_frame_constants(s.buffers, cam, s.lights)
        sides.append((r, r.precompute_shadow_maps(c, (64, 64, 64))))
    hist, prev = [None, None], None
    for turn in (0.0, 3.0):
        cam.yaw += turn
        outs, recs = [], []
        for i, (r, maps) in enumerate(sides):
            c = r.build_frame_constants(s.buffers, cam, s.lights,
                                        prev_view_proj=prev)
            rec = {}
            restore = _record_selections(rec)
            before = _backend.launches["palette"]
            try:
                outs.append(r.render(c, 192, 108, ssr_history=hist[i],
                                     shadow_maps=maps, **flags))
            finally:
                restore()
            if i == 0:
                assert _backend.launches["palette"] - before == (4 if ids == () else 5)
            recs.append(rec)
        prev = c.view_proj.numpy()
        for k in ("fetch", "texel"):
            assert len(recs[0][k]) == len(recs[1][k]) > 0
            assert all(torch.equal(a, b) for a, b in zip(recs[0][k], recs[1][k])), k
        out, ref = outs
        bars = {"ldr": 3e-4, "ao": AO_TOL, "motion": MOTION_TOL,
                "ssr_history": HIST_TOL}
        for k, bar in bars.items():
            assert float((out[k].cpu() - ref[k]).abs().max()) <= bar, k
        hist = [o["ssr_history"] for o in outs]
    assert float(outs[0]["motion"].abs().max()) > 1e-3


@pytest.mark.parametrize("preset", ["lowest", "low", "medium", "high", "adaptive"])
def test_ssao_presets_on_card_match_cpu(cuda, preset):
    """render_forward's SSAO branch with each preset on the Default scene
    at 192x108 (no environment, shadows off): every tap fetch equal to the
    CPU's, the AO within AO_TOL, the saturation equal."""
    s = load_scene("Default", 192, 108)
    outs, recs = [], []
    for d in (cuda, torch.device("cpu")):
        r = VQRendererTorch(d)
        r.load_scene(s.buffers)
        c = r.build_frame_constants(s.buffers, s.cameras[0], s.lights)
        rec = {}
        restore = _record_selections(rec)
        try:
            outs.append(r.render(c, 192, 108, env=None, enable_shadows=False,
                                 enable_ssao=True, ssao_quality=preset))
        finally:
            restore()
        recs.append(rec)
    assert all(torch.equal(a, b) for a, b in zip(recs[0]["fetch"], recs[1]["fetch"]))
    assert float((outs[0]["ao"].cpu() - outs[1]["ao"]).abs().max()) <= AO_TOL
    for k, v in outs[1]["saturation"].items():
        assert float(outs[0]["saturation"][k]) == float(v), k


@pytest.mark.parametrize("golden", ["default_ssao", "default_ssr"])
def test_default_goldens_on_card(cuda, golden):
    """The goldens default_ssao and default_ssr rendered on the card, within
    the bars of engine/goldens.py."""
    from vqengine_tpu_torch.engine.goldens import golden_scores, render_golden
    s = golden_scores(golden, render_golden(golden, cuda))
    assert s["ok"], s


@pytest.mark.parametrize("golden", ["textured_quad", "gltf_roundtrip", "sponza"])
def test_textured_and_sponza_goldens_on_card(cuda, golden):
    """The goldens textured_quad, gltf_roundtrip and sponza rendered on the
    card, within the bars of engine/goldens.py (sponza is checked only on
    the card: at the default environment sizes and 256^2 directional maps
    it takes about a minute on one CPU core)."""
    from vqengine_tpu_torch.engine.goldens import golden_scores, render_golden
    s = golden_scores(golden, render_golden(golden, cuda))
    assert s["ok"], s


def test_texture_roundings_on_card(cuda):
    """The XLA-rounding helpers of ops/texture.py give the CPU's bits on the
    card: log_xla and log2_xla (FMAs through f64), cross_xla, the R2
    jitter; srgb_to_linear_fast (f64 pow) within one f32 ulp."""
    from vqengine_tpu_torch.ops import colorspace, texture
    g = torch.Generator().manual_seed(3)
    x = torch.exp(torch.empty(200_000).uniform_(-16.0, 14.0, generator=g))
    a, b = torch.randn(50_000, 3, generator=g), torch.randn(50_000, 3, generator=g)
    for fn, args in ((texture.log_xla, (x,)), (texture.log2_xla, (x,)),
                     (texture.cross_xla, (a, b))):
        assert bitwise(fn(*(t.to(cuda) for t in args)).cpu(), fn(*args))
    assert bitwise(texture.mip_jitter(108, 192, device=cuda).cpu(),
                   texture.mip_jitter(108, 192))
    c = torch.rand(200_000, generator=g)
    d = (colorspace.srgb_to_linear_fast(c.to(cuda)).cpu().view(torch.int32)
         - colorspace.srgb_to_linear_fast(c).view(torch.int32)).abs()
    assert int(d.max()) <= 1


def test_textured_frames_on_card(cuda):
    """goldens.atrium_scene at 192x108 with the aniso-8 walk, the alpha
    peel and the textured glass, without and with MSAA ("shade" resolve),
    on the card and on the CPU: tri_id equal, ldr within 3e-4, the texture
    telemetry equal and every tap's level and row equal; the peel and the
    glass layers launch K1-bounded on the card."""
    from vqengine_tpu_torch.engine import goldens
    from vqengine_tpu_torch.ops import texture
    from vqengine_tpu_torch.render.scene_buffers import split_transparent
    rows = texture._tap_rows
    outs = []
    for d in (cuda, torch.device("cpu")):
        buffers, tex, cam, lights = goldens.atrium_scene(d, aspect=192 / 108)
        opaque, transp = split_transparent(buffers)
        r = VQRendererTorch(d)
        c = r.build_frame_constants(buffers, cam, lights)
        scene, scene_t = graph.upload_scene(opaque, d), graph.upload_scene(transp, d)
        for flags in ({}, {"msaa": True, "msaa_edge_resolve": "shade"}):
            taps = []

            def rec(pt, tex_id, uv, lodi, pair, taps=taps):
                out = rows(pt, tex_id, uv, lodi, pair)
                taps.append((lodi.cpu(), out[0].cpu()))
                return out
            texture._tap_rows = rec
            before = _backend.launches["raster_gbuf_bounded"] + \
                _backend.launches["raster_gbuf_msaa_bounded"]
            try:
                o = graph.render_forward(
                    scene, c, 192, 108, enable_shadows=False, textures=tex,
                    slots_used=graph.slots_used_of(buffers.materials),
                    aniso_taps=8, enable_alpha_mask=True,
                    scene_transparent=scene_t, **flags)
            finally:
                texture._tap_rows = rows
            k1b = (_backend.launches["raster_gbuf_bounded"]
                   + _backend.launches["raster_gbuf_msaa_bounded"] - before)
            outs.append((o, taps, k1b))
    for (o, taps, k1b), (oc, taps_c, _) in zip(outs[:2], outs[2:]):
        assert k1b == 3
        assert torch.equal(o["tri_id"].cpu(), oc["tri_id"])
        assert float((o["ldr"].cpu() - oc["ldr"]).abs().max()) <= 3e-4
        assert len(taps) == len(taps_c) > 0
        for (la, ra), (lb, rb) in zip(taps, taps_c):
            assert torch.equal(la, lb) and torch.equal(ra, rb)
        for k in ("tex_aniso", "tex_aniso_demand"):
            assert float(o["saturation"][k]) == float(oc["saturation"][k]), k
