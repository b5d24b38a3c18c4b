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


@pytest.mark.parametrize("m,k", [(7, 32), (85, 16), (85, 9), (85, 2), (3, 17)])
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
