"""Parity of the port's texture slice with the JAX package on the CPU:
scene/texture_manager.py (mips, procedural images, the combined aux maps
and the pair table), scene/gltf.py and gltf_export.py, the stress scene's
host tables against bench.build_sponza_stress, every function of
ops/texture.py, the renderer's keys, the textured goldens and
tests/test_texture.py's properties on the port.

Each side builds its inputs with its own host modules from the same seeds.
The reference runs op by op (its sparse ops compiled whole: they round
nothing), at one shape set: [54, 96] lanes, 64^2 textures (7 levels). The
textured frames are in tests/test_torch_texture_frames.py.

Texel selections are compared tap by tap: every packed tap's mip level and
row (quad or pair row), dense and walked. The reference's row comes from
its own tap run a second time on a table whose every lane holds the row's
index (the bilinear blend of four equal lanes gives the index back); the
port's from its tap's row computation.

Tolerances: host tables, selections and the texture functions bitwise
(the port mirrors XLA's log, log2, sqrt, cross and norm roundings and the
reference's libm powf), but normals (1e-6)."""
import dataclasses
import functools
import tempfile
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from test_torch_msaa import _EXACT
from vqengine_tpu.ops import colorspace as jcs
from vqengine_tpu.ops import texture as jt
from vqengine_tpu.render import graph as jg
from vqengine_tpu.render import scene_buffers as jsb
from vqengine_tpu.scene import camera as jcam
from vqengine_tpu.scene import gltf as jgltf
from vqengine_tpu.scene import gltf_export as jgexp
from vqengine_tpu.scene import light as jlight
from vqengine_tpu.scene import material as jmat
from vqengine_tpu.scene import mesh as jmesh
from vqengine_tpu.scene import texture_manager as jtm
from vqengine_tpu.utils import math3d as jm3
from vqengine_tpu_torch.engine import goldens, scene_load
from vqengine_tpu_torch.ops import colorspace as tcs
from vqengine_tpu_torch.ops import texture as tt
from vqengine_tpu_torch.render import graph as tg
from vqengine_tpu_torch.render import scene_buffers as tsb
from vqengine_tpu_torch.render.renderer import (VQRendererTorch,
                                                frame_constants_numpy)
from vqengine_tpu_torch.scene import camera as tcam
from vqengine_tpu_torch.scene import gltf as tgltf
from vqengine_tpu_torch.scene import gltf_export as tgexp
from vqengine_tpu_torch.scene import light as tlight
from vqengine_tpu_torch.scene import material as tmat
from vqengine_tpu_torch.scene import mesh as tmesh
from vqengine_tpu_torch.scene import texture_manager as ttm
from vqengine_tpu_torch.utils import math3d as tm3

torch.set_num_threads(1)

CPU = torch.device("cpu")
W, H = 96, 54
TEX = 64
NORMAL_TOL = 1e-6

JAX = types.SimpleNamespace(sb=jsb, cam=jcam, light=jlight, mat=jmat,
                            mesh=jmesh, m3=jm3, tm=jtm, gltf=jgltf, gexp=jgexp)
PORT = types.SimpleNamespace(sb=tsb, cam=tcam, light=tlight, mat=tmat,
                             mesh=tmesh, m3=tm3, tm=ttm, gltf=tgltf, gexp=tgexp)


@pytest.fixture(scope="module", autouse=True)
def compiled_exact_ops():
    """The reference's ops/sparse.py compiled whole (they count, move and
    compare, and round nothing; tests/test_torch_msaa.py)."""
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
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# texel selections
# ---------------------------------------------------------------------------

def _rows_of(rgba) -> np.ndarray:
    """A tap's output on a table whose lanes hold their row index -> the
    index (its four bytes, each blended from four equal lanes)."""
    b = np.rint(np.asarray(rgba, np.float64) * 255.0).astype(np.int64)
    return b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)


@functools.cache
def _index_table(n: int, lanes: int):
    return jnp.asarray(np.repeat(np.arange(n, dtype=np.int32)[:, None], lanes, 1))


class Selections:
    """While active, every packed tap of both sides appends (level, row)
    to ref / port, in call order."""

    def __init__(self):
        self.ref, self.port = [], []

    def __enter__(self):
        self._saved = (jt._packed_tap, jt._packed_pair_tap, tt._tap_rows)
        tap, pair_tap, rows = self._saved

        def ref_tap(pt, tex_id, uv, lodi):
            probe = dataclasses.replace(pt, flat=_index_table(pt.flat.shape[0], 4))
            self.ref.append((np.asarray(lodi), _rows_of(tap(probe, tex_id, uv, lodi))))
            return tap(pt, tex_id, uv, lodi)

        def ref_pair_tap(pt, pair_id, uv, lodi):
            probe = dataclasses.replace(
                pt, pair_flat=_index_table(pt.pair_flat.shape[0], 8))
            self.ref.append((np.asarray(lodi),
                             _rows_of(pair_tap(probe, pair_id, uv, lodi)[0])))
            return pair_tap(pt, pair_id, uv, lodi)

        def port_rows(pt, tex_id, uv, lodi, pair):
            out = rows(pt, tex_id, uv, lodi, pair)
            self.port.append((lodi.long().numpy(), out[0].numpy()))
            return out
        jt._packed_tap, jt._packed_pair_tap, tt._tap_rows = ref_tap, ref_pair_tap, port_rows
        return self

    def __exit__(self, *exc):
        jt._packed_tap, jt._packed_pair_tap, tt._tap_rows = self._saved

    def mismatches(self) -> dict:
        """{"taps": taps recorded, "levels", "rows": mismatched lanes}."""
        assert len(self.ref) == len(self.port), (len(self.ref), len(self.port))
        out = {"taps": len(self.ref), "lanes": 0, "levels": 0, "rows": 0}
        for (rl, rr), (pl, pr) in zip(self.ref, self.port):
            assert rl.shape == pl.shape and rr.shape == pr.shape
            out["lanes"] += rl.size
            out["levels"] += int((rl.astype(np.int64) != pl).sum())
            out["rows"] += int((rr != pr).sum())
        return out


def assert_same_selections(sel: Selections, what: str):
    m = sel.mismatches()
    assert m["taps"] > 0, what
    assert m["levels"] == 0 and m["rows"] == 0, (what, m)


# ---------------------------------------------------------------------------
# host side: texture manager, glTF, the stress scene
# ---------------------------------------------------------------------------

PROCEDURAL = {
    "checkerboard": lambda tm: tm.checkerboard(TEX, 8),
    "checkerboard_grayscale": lambda tm: tm.checkerboard_grayscale(TEX),
    "flat_normal": lambda tm: tm.flat_normal(8),
    "brick": lambda tm: tm.brick(TEX),
    "noise": lambda tm: tm.noise_texture(TEX, seed=3),
    "normal_from_height": lambda tm: tm.normal_from_height(
        tm.noise_texture(TEX, seed=21), 1.6),
}


@pytest.mark.parametrize("name", sorted(PROCEDURAL))
def test_procedural_images_match(name):
    assert_bitwise(PROCEDURAL[name](ttm), PROCEDURAL[name](jtm), name)


@pytest.mark.parametrize("native", [True, False])
def test_generate_mips_matches_jax(native, monkeypatch):
    """The port's box filter ((a + b) + c) + d, 0.25 times, against the
    reference's native kernel where it is built and its numpy mean."""
    from vqengine_tpu.utils import native as jnative
    if not native:
        monkeypatch.setattr(jnative, "mip_box", lambda _: None)
    elif not jnative.available():
        pytest.skip("the JAX package's native library is not built")
    img = np.random.default_rng(0).random((256, 256, 4)).astype(np.float32)
    for src in (img, ttm.brick(TEX)):
        a, b = ttm.generate_mips(src), jtm.generate_mips(src)
        assert len(a) == len(b)
        for lv, (x, y) in enumerate(zip(a, b)):
            assert_bitwise(x, y, f"level {lv}")


def _levels(pkg):
    per = [pkg.tm.generate_mips(f(pkg.tm)) for k, f in sorted(PROCEDURAL.items())
           if k != "flat_normal"]
    return [np.stack([m[lv] for m in per]) for lv in range(len(per[0]))]


@pytest.fixture(scope="module")
def packed():
    """Both sides' packed tables of five 64^2 procedural images, with
    three pairs (one without an aux map, one without a diffuse map)."""
    pairs = [(0, 1), (2, -1), (-1, 4)]
    ref = jt.pack_texture_pairs(_levels(JAX), pairs, jt.pack_texture_quads(_levels(JAX)))
    lv = _levels(PORT)
    port = tt.pack_texture_pairs(lv, pairs, tt.pack_texture_quads(lv, CPU))
    return ref, port


def test_packed_tables_match(packed):
    ref, port = packed
    assert_bitwise(port.flat, ref.flat, "quads")
    assert_bitwise(port.pair_flat, ref.pair_flat, "pairs")
    assert (port.offs, port.sizes, port.pair_offs) == (ref.offs, ref.sizes,
                                                       ref.pair_offs)
    # the level tables a port tap gathers at its level
    assert port.level_int[:, 0].tolist() == list(ref.sizes)
    assert port.level_int[:, 2].tolist() == list(ref.offs)
    assert port.level_int[:, 3].tolist() == list(ref.pair_offs)


def _aux_materials(pkg):
    """Materials over every combination the aux and pair passes treat
    differently: two of three maps, all three, one (left alone), shared
    keys, diffuse only, none."""
    specs = [{"diffuse": 0, "normal": 1, "roughness": 2},
             {"normal": 1, "metallic": 3},
             {"diffuse": 4, "normal": 1, "roughness": 2, "metallic": 3},
             {"roughness": 2},
             {"diffuse": 0, "normal": 1, "roughness": 2},
             {"diffuse": 4}, {}]
    mats = []
    for i, tex in enumerate(specs):
        m = pkg.mat.Material(name=f"m{i}")
        m.textures = dict(tex)
        mats.append(m)
    return mats


@pytest.mark.parametrize("mip_bias", [0.0, 0.5])
def test_combine_aux_and_pairs_match(mip_bias):
    """combine_aux_maps and combine_pair_quads on both sides: the
    materials' slots, combined aux and pair ids, the new images, the pair
    table and the packed rows; a nonzero normal-map mip bias pairs
    nothing."""
    out = []
    for pkg in (PORT, JAX):
        tm = pkg.tm.TextureManager(size=16)
        for k in ("checkerboard", "normal_from_height", "noise", "brick", "checkerboard_grayscale"):
            tm.create_from_array(k, PROCEDURAL[k](pkg.tm)[:16, :16])
        mats = _aux_materials(pkg)
        mats[0].normal_map_mip_bias = mip_bias
        counts = (tm.combine_aux_maps(mats), tm.combine_pair_quads(mats))
        out.append((counts, [(m.textures, m.combined_aux, m.pair_map) for m in mats],
                    tm._pairs, tm._images))
    (pc, pm, pp, pimg), (jc, jm, jp, jimg) = out
    assert pc == jc and pm == jm and pp == jp
    assert (pc[1] == 0) == (mip_bias != 0.0)
    assert len(pimg) == len(jimg)
    for a, b in zip(pimg, jimg):
        assert_bitwise(a, b)


def test_texture_manager_files_match(tmp_path):
    """create_from_file through each side's image decoder: a PNG and a
    missing file (FAILED; the engine drops that slot), then the packed
    upload; the port's upload lands on the requested device."""
    from vqengine_tpu_torch.utils.image_io import write_png
    img = (np.random.default_rng(5).random((20, 24, 3)) * 255).astype(np.uint8)
    write_png(tmp_path / "a.png", img)
    got = []
    for pkg in (PORT, JAX):
        tm = pkg.tm.TextureManager(size=16)
        ids = [tm.create_from_file("a.png", search_dirs=[tmp_path]),
               tm.create_from_file("missing.png", search_dirs=[tmp_path]),
               tm.create_from_file("a.png", search_dirs=[tmp_path])]
        tm.wait_all()
        got.append((ids, [tm.state(i) for i in ids], tm._images))
    assert got[0][0] == got[1][0] == [0, 1, 0]
    assert [int(s) for s in got[0][1]] == [int(s) for s in got[1][1]]
    assert got[0][1][1] == ttm.ETextureState.FAILED
    for a, b in zip(got[0][2], got[1][2]):
        assert_bitwise(a, b)
    tm = ttm.TextureManager(size=16)
    tm.create_from_file("a.png", search_dirs=[tmp_path])
    up = tm.build_device_arrays_packed(CPU)
    assert up.flat.device == CPU and up.pair_flat is None
    levels = tm.build_device_arrays(CPU)
    assert [tuple(x.shape) for x in levels] == [(1, s, s, 4) for s in up.sizes]


def _gltf_objects(pkg):
    mats = []
    for name, dif, rough, metal in (("floor", (0.5, 0.45, 0.4), 0.8, 0.0),
                                    ("ball", (0.8, 0.3, 0.2), 0.25, 0.0),
                                    ("pillar", (0.7, 0.65, 0.3), 0.4, 1.0)):
        m = pkg.mat.Material(name=name)
        m.diffuse = np.asarray(dif, np.float32)
        m.roughness = rough
        m.metalness = metal
        mats.append(m)
    m3, mesh = pkg.m3, pkg.mesh
    return [
        ("floor", mesh.quad(4.0).lods[0],
         m3.Transform(rotation=m3.quat_from_euler_xyz_degrees(90, 0, 0)).matrix(),
         mats[0]),
        ("ball", mesh.sphere(0.8, 16, 16).lods[0],
         m3.Transform(position=np.array([-0.9, 0.8, 0], np.float32)).matrix(),
         mats[1]),
        ("pillar", mesh.cylinder(2.0, 0.4, 0.4).lods[0],
         m3.Transform(position=np.array([1.0, 1.0, 0.5], np.float32)).matrix(),
         mats[2]),
    ]


def test_gltf_roundtrip_matches_jax(tmp_path):
    """export_glb's bytes, and load_gltf_meshes' arrays and materials, of
    the gltf_roundtrip golden's still life on both sides."""
    loaded = []
    for tag, pkg in (("port", PORT), ("jax", JAX)):
        path = tmp_path / f"{tag}.glb"
        pkg.gexp.export_glb(_gltf_objects(pkg), path)
        loaded.append((path.read_bytes(), pkg.gltf.load_gltf_meshes(path)))
    (pb, pm), (jb, jm) = loaded
    assert pb == jb
    assert len(pm) == len(jm) == 3
    for (m1, mat1), (m2, mat2) in zip(pm, jm):
        assert m1.name == m2.name and len(m1.lods) == len(m2.lods)
        for l1, l2 in zip(m1.lods, m2.lods):
            for f in dataclasses.fields(l1):
                a, b = getattr(l1, f.name), getattr(l2, f.name)
                if isinstance(a, np.ndarray):
                    assert_bitwise(a, b, f.name)
        assert_bitwise(mat1.pack(), mat2.pack(), mat1.name)


def test_stress_scene_host_tables_match(tmp_path, monkeypatch):
    """scene_load.sponza_stress against bench.build_sponza_stress, host
    only (one BLAS thread; the reference's .glb goes under tmp_path): every
    array of the scene buffers, the packed quad and pair tables and the
    lights' packed rows, bitwise."""
    import bench
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    with threadpool_limits(limits=1):
        jb, jl, jtex = bench.build_sponza_stress()
        pb, pl, ptex = scene_load.sponza_stress(CPU)
    for f in dataclasses.fields(jb):
        a, b = getattr(jb, f.name), getattr(pb, f.name)
        if isinstance(a, np.ndarray):
            assert_bitwise(b, a, f.name)
    assert pb.indices.shape[0] > 250_000
    assert_bitwise(ptex.flat, jtex.flat, "quads")
    assert_bitwise(ptex.pair_flat, jtex.pair_flat, "pairs")
    assert (ptex.offs, ptex.sizes, ptex.pair_offs) == (jtex.offs, jtex.sizes,
                                                       jtex.pair_offs)
    assert len(pl) == len(jl) == 17
    for a, b in zip(pl, jl):
        assert int(a.type) == int(b.type) and a.casts_shadows == b.casts_shadows
        assert_bitwise(np.asarray(a.position, np.float32),
                       np.asarray(b.position, np.float32))
    assert tg.slots_used_of(pb.materials) == jg.slots_used_of(jb.materials)


# ---------------------------------------------------------------------------
# device functions
# ---------------------------------------------------------------------------

def test_log2_matches_xla():
    """log_xla and log2_xla bitwise against jnp.log and jnp.log2 on random
    f32 over [1e-7, 1e6], powers of two and the clamp values."""
    rng = np.random.default_rng(1)
    x = np.exp(rng.uniform(np.log(1e-7), np.log(1e6), 400_000)).astype(np.float32)
    x = np.concatenate([x, np.float32(2.0) ** np.arange(-24, 24, dtype=np.float32),
                        np.asarray([1.0, 8.0, 1e-6, 1.3, 1.0000001], np.float32)])
    assert_bitwise(tt.log_xla(t_(x)), jnp.log(jnp.asarray(x)), "log")
    assert_bitwise(tt.log2_xla(t_(x)), jnp.log2(jnp.asarray(x)), "log2")


def test_cross_and_srgb_match():
    """cross_xla bitwise against jnp.cross; srgb_to_linear_fast (glibc's
    powf, colorspace.powf) bitwise against the reference's jnp.power on
    [0, 1] and the 256 RGBA8 levels."""
    rng = np.random.default_rng(2)
    a = rng.standard_normal((50_000, 3)).astype(np.float32)
    b = rng.standard_normal((50_000, 3)).astype(np.float32)
    assert_bitwise(tt.cross_xla(t_(a), t_(b)), jnp.cross(jnp.asarray(a), jnp.asarray(b)))
    c = np.concatenate([rng.random(200_000).astype(np.float32),
                        (np.arange(256) / 255.0).astype(np.float32), [-0.5]])
    got = tcs.srgb_to_linear_fast(t_(c)).numpy()
    ref = np.asarray(jcs.srgb_to_linear_fast(jnp.asarray(c)))
    assert_bitwise(got, ref, "srgb_to_linear_fast")


def _uv_field(seed: int = 0) -> np.ndarray:
    """A smooth [H, W, 2] uv field whose anisotropy grows row by row from
    about 1 to about 300 (a grazing floor's), with a seam; the first row
    and column hold one uv (the edge-clamped gradients vanish there)."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    rng = np.random.default_rng(seed)
    u = xx / W * 3.0 + 0.05 * yy / H + rng.uniform(-1e-3, 1e-3, (H, W))
    v = np.cumsum(0.03 * 300.0 ** (yy / (H - 1)), axis=0) + 0.004 * xx
    v[:, W // 2:] += 0.37
    uv = np.stack([u, v], -1)
    uv[0, :] = uv[:, 0] = uv[0, 0]
    return uv.astype(np.float32)


@pytest.fixture(scope="module")
def lanes():
    """Per-pixel inputs at the frame's shape: uv, texture and pair ids (some
    -1), a level map, the R2 jitter."""
    rng = np.random.default_rng(3)
    return {"uv": _uv_field(), "uv_rand": rng.uniform(-3, 3, (H, W, 2)).astype(np.float32),
            "tid": rng.integers(-1, 5, (H, W)).astype(np.int32),
            "pid": rng.integers(0, 3, (H, W)).astype(np.int32),
            "lodi": rng.integers(0, 7, (H, W)).astype(np.int32),
            "lod": rng.uniform(-0.5, 7.5, (H, W)).astype(np.float32),
            "jit": np.asarray(jt.mip_jitter(H, W))}


def test_mip_jitter_and_gradients_match(lanes):
    assert_bitwise(tt.mip_jitter(H, W), jt.mip_jitter(H, W), "jitter")
    # a screen band's rows (ported with the multi-GPU slice; it raised
    # before): the reference's pattern at those rows
    assert_bitwise(tt.mip_jitter(H, W, y_offset=3),
                   jt.mip_jitter(H, W, y_offset=3), "jitter at a band")
    for a, b in zip(tt.uv_gradients(t_(lanes["uv"])),
                    jt.uv_gradients(jnp.asarray(lanes["uv"]))):
        assert_bitwise(a, b)


@pytest.mark.parametrize("field", ["uv", "uv_rand"])
def test_uv_mip_levels_match(lanes, field):
    """uv_mip_level and uv_mip_level_aniso (lod, major step, clamped and
    unclamped ratio), bitwise."""
    uv = lanes[field]
    assert_bitwise(tt.uv_mip_level(t_(uv), TEX, 6),
                   jt.uv_mip_level(jnp.asarray(uv), TEX, 6), "lod")
    for k, (a, b) in enumerate(zip(
            tt.uv_mip_level_aniso(t_(uv), TEX, 6, max_aniso=8.0),
            jt.uv_mip_level_aniso(jnp.asarray(uv), TEX, 6, max_aniso=8.0))):
        assert_bitwise(a, b, f"aniso output {k}")


def test_packed_taps_match(packed, lanes):
    """_packed_tap and _packed_pair_tap at every level on random uv and
    ids: rgba bitwise and every selection equal."""
    ref, port = packed
    args = [lanes[k] for k in ("tid", "uv_rand", "lodi")]
    pargs = [lanes[k] for k in ("pid", "uv_rand", "lodi")]
    with Selections() as sel:
        assert_bitwise(tt._packed_tap(port, *map(t_, args)),
                       jt._packed_tap(ref, *map(jnp.asarray, args)), "quad tap")
        for a, b in zip(tt._packed_pair_tap(port, *map(t_, pargs)),
                        jt._packed_pair_tap(ref, *map(jnp.asarray, pargs))):
            assert_bitwise(a, b, "pair tap")
    assert_same_selections(sel, "taps")
    assert sel.mismatches()["lanes"] == 2 * H * W


@pytest.mark.parametrize("mode", ["trilinear", "jitter", "nearest", "auto_lod"])
def test_sample_texture_array_matches(packed, lanes, mode):
    """sample_texture_array on both layouts (the quad-packed table, and
    the f32 level list through _bilinear_indices) and sample_texture_pair:
    bitwise, selections equal."""
    ref, port = packed
    kw_r, kw_p = {}, {}
    if mode != "auto_lod":
        kw_r["lod"], kw_p["lod"] = jnp.asarray(lanes["lod"]), t_(lanes["lod"])
    if mode == "jitter":
        kw_r["jitter"], kw_p["jitter"] = jnp.asarray(lanes["jit"]), t_(lanes["jit"])
    if mode == "nearest":
        kw_r["trilinear"] = kw_p["trilinear"] = False
    uv, tid = lanes["uv"], lanes["tid"]
    with Selections() as sel:
        assert_bitwise(tt.sample_texture_array(port, t_(tid), t_(uv), **kw_p),
                       jt.sample_texture_array(ref, jnp.asarray(tid), jnp.asarray(uv), **kw_r))
        if mode in ("trilinear", "jitter"):
            pid = lanes["pid"]
            for a, b in zip(
                    tt.sample_texture_pair(port, t_(pid), t_(uv), kw_p["lod"],
                                           jitter=kw_p.get("jitter")),
                    jt.sample_texture_pair(ref, jnp.asarray(pid), jnp.asarray(uv),
                                           kw_r["lod"], jitter=kw_r.get("jitter"))):
                assert_bitwise(a, b, "pair")
    assert_same_selections(sel, mode)
    lv = _levels(PORT)
    assert_bitwise(tt.sample_texture_array([t_(x) for x in lv], t_(tid), t_(uv), **kw_p),
                   jt.sample_texture_array([jnp.asarray(x) for x in lv],
                                           jnp.asarray(tid), jnp.asarray(uv), **kw_r),
                   "f32 levels")


@pytest.mark.parametrize("taps,frac", [(2, 32), (8, None), (8, 32)])
def test_aniso_matches(packed, lanes, taps, frac):
    """sample_texture_array_aniso dense (2 taps, or no capacity) and with
    the adaptive walk on the grazing field (more demand than the 512-lane
    capacity: the ladder's rung above 1.3), and sample_texture_pair_aniso:
    bitwise, every dense and walked tap's selection equal, the rung's
    telemetry equal."""
    ref, port = packed
    uv, tid, pid, jit = (lanes[k] for k in ("uv", "tid", "pid", "jit"))
    tel_r, tel_p = {}, {}
    with Selections() as sel:
        assert_bitwise(
            tt.sample_texture_array_aniso(port, t_(tid), t_(uv), num_taps=taps,
                                          jitter=t_(jit), adaptive_frac=frac,
                                          telemetry=tel_p),
            jt.sample_texture_array_aniso(ref, jnp.asarray(tid), jnp.asarray(uv),
                                          num_taps=taps, jitter=jnp.asarray(jit),
                                          adaptive_frac=frac, telemetry=tel_r))
        if frac is not None and taps > 2:
            for a, b in zip(
                    tt.sample_texture_pair_aniso(port, t_(pid), t_(tid), t_(uv),
                                                 num_taps=taps, jitter=t_(jit),
                                                 adaptive_frac=frac),
                    jt.sample_texture_pair_aniso(ref, jnp.asarray(pid), jnp.asarray(tid),
                                                 jnp.asarray(uv), num_taps=taps,
                                                 jitter=jnp.asarray(jit),
                                                 adaptive_frac=frac)):
                assert_bitwise(a, b, "pair aniso")
    assert_same_selections(sel, f"aniso {taps} {frac}")
    assert sorted(tel_p) == sorted(tel_r)
    for k in tel_r:
        assert_bitwise(tel_p[k], tel_r[k], k)
    if frac is not None and taps > 2:
        # demand past the capacity: the ladder walks a rung above 1.3
        cap = -(-max(512, H * W // frac) // 8) * 8
        _, _, _, raw = tt.uv_mip_level_aniso(t_(uv), TEX, 6, max_aniso=8.0)
        thr, _ = tt.sparse.adaptive_threshold(raw, tt.ANISO_THRS, cap, block=8)
        assert float(tel_p["tex_aniso_demand"]) > 1.0
        assert tt.ANISO_THRS[0] < float(thr) < float("inf")
        assert 0.0 < float(tel_p["tex_aniso"]) <= 1.0


def test_normal_unpacks_match(lanes):
    """unpack_normal_map and unpack_normal_map_xy within 1e-6 (bitwise
    where the port mirrors the roundings) on random normals, tangents and
    samples."""
    rng = np.random.default_rng(4)
    n = rng.standard_normal((H, W, 3)).astype(np.float32)
    t = rng.standard_normal((H, W, 3)).astype(np.float32)
    s = rng.random((H, W, 3)).astype(np.float32)
    for fn, arg in (("unpack_normal_map", s), ("unpack_normal_map_xy", s[..., :2])):
        got = getattr(tt, fn)(t_(arg), t_(n), t_(t)).numpy()
        ref = np.asarray(getattr(jt, fn)(jnp.asarray(arg), jnp.asarray(n), jnp.asarray(t)))
        np.testing.assert_allclose(got, ref, rtol=0, atol=NORMAL_TOL, err_msg=fn)


def test_renderer_keys_textures_at_load():
    """VQRendererTorch.load_scene takes the slot usage and the alpha-mask
    permutation from the materials, as the reference's renderer does, and
    render samples the scene's textures unless textures=None."""
    buffers, tex, cam, lights = goldens.atrium_scene(CPU, aspect=W / H)
    r = VQRendererTorch(CPU)
    r.load_scene(buffers, textures=tex)
    assert r._slots_used == tg.slots_used_of(buffers.materials)
    assert r._any_alpha_mask and r._slots_used[3] and r._slots_used[9]
    c = r.build_frame_constants(buffers, cam, lights)
    out = r.render(c, W, H, enable_shadows=False, aniso_taps=8)
    bare = r.render(c, W, H, enable_shadows=False, textures=None)
    assert "tex_aniso" in out["saturation"] and "tex_aniso" not in bare["saturation"]
    assert not torch.equal(out["ldr"], bare["ldr"])


@pytest.mark.parametrize("golden", goldens.TEXTURED)
def test_textured_goldens_on_port(golden):
    """The goldens textured_quad and gltf_roundtrip through the port on
    the CPU, within the reference's bars."""
    with threadpool_limits(limits=1):       # the LUT fit's BLAS
        s = goldens.golden_scores(golden, goldens.render_golden(golden, CPU))
    assert s["ok"], s


# ---------------------------------------------------------------------------
# tests/test_texture.py's properties, on the port
# ---------------------------------------------------------------------------

def _p_create_dedup_and_states():
    tm = ttm.TextureManager(size=32)
    a = tm.create_from_array("a", np.ones((16, 16, 3), np.float32))
    b = tm.create_from_array("a", np.zeros((16, 16, 3), np.float32))
    assert a == b and tm.state(a) == ttm.ETextureState.READY


def _p_missing_file_fails():
    tm = ttm.TextureManager(size=32)
    tid = tm.create_from_file("does/not/exist.png")
    tm.wait_all()
    assert tm.state(tid) == ttm.ETextureState.FAILED


def _p_device_arrays_mips():
    tm = ttm.TextureManager(size=64)
    tm.create_from_array("c", ttm.checkerboard(64, 8))
    mips = tm.build_device_arrays(CPU)
    assert tuple(mips[0].shape) == (1, 64, 64, 4) and mips[-1].shape[1] == 1
    np.testing.assert_allclose(mips[-1][0, 0, 0, :3].numpy(), 0.5, atol=0.01)


def _p_mips_energy():
    img = np.random.default_rng(0).uniform(0, 1, (32, 32, 4)).astype(np.float32)
    mips = ttm.generate_mips(img)
    assert len(mips) == 6 and abs(mips[-1].mean() - img.mean()) < 1e-3


def _p_identity_sample():
    img = np.random.default_rng(1).uniform(0, 1, (16, 16, 4)).astype(np.float32)
    c = (torch.arange(16) + 0.5) / 16
    uv = torch.stack(torch.meshgrid(c, c, indexing="xy"), -1)
    out = tt.sample_texture_array([t_(img[None])], torch.zeros((16, 16), dtype=torch.int32),
                                  uv, lod=torch.zeros((16, 16)))
    np.testing.assert_allclose(out.numpy(), img, atol=1e-5)


def _p_mip_selection_by_derivatives():
    def grid(hi):
        g = torch.linspace(0, hi, 32)
        return torch.stack(torch.meshgrid(g, g, indexing="xy"), -1)
    lod_f = tt.uv_mip_level(grid(0.1), 64, 6)
    lod_c = tt.uv_mip_level(grid(8.0), 64, 6)
    assert float(lod_c.mean()) > float(lod_f.mean()) + 2


def _p_normal_unpack_identity():
    out = tt.unpack_normal_map(torch.tensor([[0.5, 0.5, 1.0]]),
                               torch.tensor([[0.0, 1.0, 0.0]]),
                               torch.tensor([[1.0, 0.0, 0.0]]))
    np.testing.assert_allclose(out.numpy(), [[0, 1, 0]], atol=1e-5)


def _p_normal_unpack_perturbed():
    out = tt.unpack_normal_map(torch.tensor([[1.0, 0.5, 0.5]]),
                               torch.tensor([[0.0, 1.0, 0.0]]),
                               torch.tensor([[1.0, 0.0, 0.0]])).numpy()
    assert out[0, 0] > 0.5
    np.testing.assert_allclose(np.linalg.norm(out), 1.0, atol=1e-5)


def _mips16(rng, n=3, size=16):
    per = [ttm.generate_mips(rng.random((size, size, 4)).astype(np.float32))
           for _ in range(n)]
    return [np.stack([m[lv] for m in per]) for lv in range(len(per[0]))]


def _p_packed_matches_f32_bilinear():
    rng = np.random.default_rng(11)
    mips = _mips16(rng)
    packed = tt.pack_texture_quads(mips, CPU)
    uv = t_(rng.uniform(-1.5, 2.5, (24, 24, 2)).astype(np.float32))
    tid = t_(rng.integers(0, 3, (24, 24)).astype(np.int32))
    for lod in (0.0, 1.3, 3.0):
        lv = torch.full((24, 24), lod)
        ref = tt.sample_texture_array([t_(m) for m in mips], tid, uv, lv)
        got = tt.sample_texture_array(packed, tid, uv, lv)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2.5 / 255.0)


def _p_aniso_dispatch():
    mips = _mips16(np.random.default_rng(12))
    packed = tt.pack_texture_quads(mips, CPU)
    yy, xx = np.mgrid[0:16, 0:16].astype(np.float32)
    uv = t_(np.stack([xx / 16, yy / 16 * 4.0], -1))
    tid = torch.zeros((16, 16), dtype=torch.int32)
    ref = tt.sample_texture_array_aniso([t_(m) for m in mips], tid, uv)
    got = tt.sample_texture_array_aniso(packed, tid, uv)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=3.0 / 255.0)


def _aux_quad_frame(combine: bool) -> np.ndarray:
    tm = ttm.TextureManager(size=32)
    n_id = tm.create_from_array("n", ttm.normal_from_height(ttm.noise_texture(32, seed=5), 1.5))
    r_id = tm.create_from_array("r", ttm.noise_texture(32, base=0.5, amp=0.4))
    mat = tmat.Material(name="m", roughness=0.9, metalness=0.3)
    mat.textures = {"normal": n_id, "roughness": r_id}
    if combine:
        assert tm.combine_aux_maps([mat]) == 1 and "normal" not in mat.textures
    tex = tm.build_device_arrays_packed(CPU)
    buffers = tsb.build_scene_buffers(
        [tsb.DrawItem("q", tmesh.quad(3.0), tm3.Transform(), 0, 0)], [mat])
    p = tcam.FCameraParameters()
    p.position = np.array([0, 0.5, -3], np.float32)
    consts = tg.frame_constants_from_numpy(frame_constants_numpy(
        buffers, tcam.Camera(p, aspect=128 / 64),
        [tlight.Light(type=tlight.ELightType.DIRECTIONAL, brightness=2.0)]), CPU)
    out = tg.render_forward(tg.upload_scene(buffers, CPU, bucketize=False), consts,
                            128, 64, textures=tex, enable_shadows=False,
                            slots_used=tg.slots_used_of(buffers.materials))
    return out["ldr"].numpy()


def _p_combined_matches_separate():
    assert np.abs(_aux_quad_frame(False) - _aux_quad_frame(True)).max() < 5e-3


def _p_unpack_xy_roundtrip():
    rng = np.random.default_rng(0)
    n_ts = rng.normal(size=(8, 8, 3)).astype(np.float32)
    n_ts[..., 2] = np.abs(n_ts[..., 2]) + 0.1
    n_ts /= np.linalg.norm(n_ts, axis=-1, keepdims=True)
    wn = torch.tensor([0.0, 0.0, 1.0]).expand(8, 8, 3)
    wt = torch.tensor([1.0, 0.0, 0.0]).expand(8, 8, 3)
    full = tt.unpack_normal_map(t_(n_ts * 0.5 + 0.5), wn, wt)
    xy = tt.unpack_normal_map_xy(t_(n_ts[..., :2] * 0.5 + 0.5), wn, wt)
    np.testing.assert_allclose(full.numpy(), xy.numpy(), atol=1e-5)


def _pair_setup():
    tm = ttm.TextureManager(size=32)
    d_id = tm.create_from_array("d", ttm.brick(32))
    n_id = tm.create_from_array("n", ttm.normal_from_height(ttm.noise_texture(32, seed=5), 1.5))
    r_id = tm.create_from_array("r", ttm.noise_texture(32, base=0.5, amp=0.4))
    mat = tmat.Material(name="m", roughness=0.9, metalness=0.3)
    mat.textures = {"diffuse": d_id, "normal": n_id, "roughness": r_id}
    assert tm.combine_aux_maps([mat]) == 1
    return tm, mat, d_id


def _p_pair_tap_matches_separate():
    tm, mat, d_id = _pair_setup()
    assert tm.combine_pair_quads([mat]) == 1
    pt = tm.build_device_arrays_packed(CPU)
    rng = np.random.default_rng(3)
    uv = t_(rng.random((16, 24, 2), np.float32) * 2.0)
    lod = t_(rng.random((16, 24), np.float32) * 4.0)
    jit = tt.mip_jitter(16, 24)

    def ids(v):
        return torch.full((16, 24), v, dtype=torch.int32)
    d_pair, a_pair = tt.sample_texture_pair(pt, ids(mat.pair_map), uv, lod, jit)
    d_sep = tt.sample_texture_array(pt, ids(d_id), uv, lod, jitter=jit)
    a_sep = tt.sample_texture_array(pt, ids(mat.combined_aux), uv, lod, jitter=jit)
    np.testing.assert_allclose(d_pair.numpy(), d_sep.numpy(), atol=1e-6)
    np.testing.assert_allclose(a_pair.numpy(), a_sep.numpy(), atol=1e-6)


def _grazing_uv(h=32, w=48):
    ys = (np.arange(h, dtype=np.float32) + 1.0)[:, None]
    xs = np.arange(w, dtype=np.float32)[None, :]
    return t_(np.stack(np.broadcast_arrays(xs / w * 4.0, 40.0 / ys), -1)
              .astype(np.float32))


def _p_pair_aniso_diffuse_matches_unpaired():
    tm, mat, d_id = _pair_setup()
    assert tm.combine_pair_quads([mat]) == 1
    pt = tm.build_device_arrays_packed(CPU)
    uv, jit = _grazing_uv(), tt.mip_jitter(32, 48)
    tid = torch.full((32, 48), d_id, dtype=torch.int32)
    pid = torch.full((32, 48), mat.pair_map, dtype=torch.int32)
    d_pair, _ = tt.sample_texture_pair_aniso(pt, pid, tid, uv, num_taps=4,
                                             jitter=jit, adaptive_frac=4)
    d_sep = tt.sample_texture_array_aniso(pt, tid, uv, num_taps=4, jitter=jit,
                                          adaptive_frac=4)
    np.testing.assert_allclose(d_pair.numpy(), d_sep.numpy(), atol=1e-6)


def _p_mip_bias_disables_pairing():
    tm, mat, _ = _pair_setup()
    mat.normal_map_mip_bias = 1.0
    assert tm.combine_pair_quads([mat]) == 0 and mat.pair_map == -1
    assert tm.build_device_arrays_packed(CPU).pair_flat is None


def _p_adaptive_matches_dense_on_aniso_pixels():
    mips = tt.pack_texture_quads([m[None] for m in ttm.generate_mips(
        ttm.checkerboard(64, 8))], CPU)
    uv = _grazing_uv()
    tid = torch.zeros((32, 48), dtype=torch.int32)
    dense = tt.sample_texture_array_aniso(mips, tid, uv, num_taps=4).numpy()
    adap = tt.sample_texture_array_aniso(mips, tid, uv, num_taps=4,
                                         adaptive_frac=1).numpy()
    _, _, ratio, _ = tt.uv_mip_level_aniso(uv, 64, 6, max_aniso=8.0)
    hi = ratio.numpy() > 1.3
    assert hi.any() and (~hi).any()
    np.testing.assert_allclose(adap[hi], dense[hi], atol=1e-6)
    assert np.abs(adap[~hi] - dense[~hi]).mean() < 0.06


TEXTURE_PROPERTIES = {k[3:]: v for k, v in globals().items() if k.startswith("_p_")}


@pytest.mark.parametrize("name", sorted(TEXTURE_PROPERTIES))
def test_texture_properties_on_port(name):
    """tests/test_texture.py's manager, sampling, packed, combined-aux,
    pair and adaptive-aniso properties, on the port's modules (its
    visualization and HUD cases belong to a later slice)."""
    TEXTURE_PROPERTIES[name]()
