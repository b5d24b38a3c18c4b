"""The port's CUDA kernels against their plain PyTorch versions on a card.

Marked gpu; every test skips without a CUDA card. On a machine with a card
(and no jax, so without the JAX suite's conftest):

    python -m pytest --noconftest tests/test_torch_gpu.py -q
"""
import pytest
import torch

from vqengine_tpu_torch.engine.scene_load import load_scene
from vqengine_tpu_torch.entry import HEIGHT, WIDTH, entry
from vqengine_tpu_torch.ops import _backend, palette, raster, shadow
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


def test_rasterize_rejects_gbuf_records(cuda):
    """K2 takes 16-row records only; K1's 32-row records raise."""
    _, (scene, consts) = entry(cuda)
    setup, extra = graph.geometry_setup_gbuf(scene, consts, WIDTH, HEIGHT)
    binned = raster.bin_triangles(setup, WIDTH, HEIGHT, extra=extra)
    with pytest.raises(ValueError):
        raster.rasterize(binned, WIDTH, HEIGHT)
