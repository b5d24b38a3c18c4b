"""The port's cull + LOD (vqengine_tpu_torch/ops/culling.py) against the
reference (vqengine_tpu/ops/culling.py), run op by op on the CPU.

Visibility and LOD are integers, and the LOD hangs on the rounding of the
projected area and of log10 near each power of ten, so both sides must
agree bitwise: a flip swaps a whole item's triangles. The port's LOD comes
from f32 area thresholds (culling.LOD_AREA_THRESHOLD_BITS); the tests find
them again here by bisection against the reference and pin the LOD on both
sides of each."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqengine_tpu.ops import culling as ref
from vqengine_tpu_torch.engine.scene_load import load_scene
from vqengine_tpu_torch.ops import culling
from vqengine_tpu_torch.render.renderer import frame_constants_numpy
from vqengine_tpu_torch.utils import math3d as m3

F32 = np.float32


def _ref_lod(area: np.ndarray, num_lods: np.ndarray) -> np.ndarray:
    return np.asarray(ref.lod_from_projected_area(jnp.asarray(area),
                                                  jnp.asarray(num_lods)))


def _port_lod(area: np.ndarray, num_lods: np.ndarray) -> np.ndarray:
    return culling.lod_from_projected_area(torch.from_numpy(area),
                                           torch.from_numpy(num_lods)).numpy()


def _rotation(rng, n: int) -> np.ndarray:
    """[n, 3, 3] random rotations (normalised random quaternions)."""
    q = rng.standard_normal((n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], 1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], 1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], 1),
    ], 1)


def _random_case(rng, n: int) -> tuple:
    """n items rotated, scaled (unevenly) and spread around a camera at a
    random pose -> (world [n, 4, 4], centers, extents, planes, view_proj,
    num_lods) as f32/int32 numpy."""
    world = np.zeros((n, 4, 4))
    world[:, :3, :3] = _rotation(rng, n) * rng.uniform(0.05, 8.0, (n, 1, 3))
    world[:, :3, 3] = rng.uniform(-200.0, 200.0, (n, 3))
    world[:, 3, 3] = 1.0
    eye = rng.uniform(-50.0, 50.0, 3)
    view = m3.look_at_lh(eye, eye + rng.standard_normal(3))
    proj = m3.perspective_lh(np.deg2rad(rng.uniform(30.0, 100.0)),
                             rng.uniform(0.5, 2.5), rng.uniform(0.05, 2.0),
                             rng.uniform(300.0, 3000.0))
    vp = (proj @ view).astype(F32)
    return (world.astype(F32), rng.uniform(-3.0, 3.0, (n, 3)).astype(F32),
            rng.uniform(1e-3, 5.0, (n, 3)).astype(F32),
            m3.frustum_planes_from_viewproj(vp).astype(F32), vp,
            rng.integers(1, 9, n).astype(np.int32))


def _both(case) -> tuple:
    """(reference, port) of (visible, lod, area) on the same inputs."""
    world, centers, extents, planes, vp, nl = case
    wc, we = ref.world_aabbs(jnp.asarray(world), jnp.asarray(centers),
                             jnp.asarray(extents))
    r = ref.cull_and_select_lod(*map(jnp.asarray, case))
    ra = ref.projected_bb_area(wc, we, jnp.asarray(vp))
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in case]
    pwc, pwe = culling.world_aabbs(*t[:3])
    p = culling.cull_and_select_lod(*t)
    pa = culling.projected_bb_area(pwc, pwe, t[4])
    return ((np.asarray(r[0]), np.asarray(r[1]), np.asarray(ra)),
            (p[0].numpy(), p[1].numpy(), pa.numpy()))


def _assert_same(case):
    (rv, rl, ra), (pv, pl, pa) = _both(case)
    assert np.array_equal(rv, pv), int((rv != pv).sum())
    assert np.array_equal(rl.astype(np.int32), pl.astype(np.int32)), \
        int((rl != pl).sum())
    assert np.array_equal(ra.view(np.int32), pa.view(np.int32)), \
        int((ra.view(np.int32) != pa.view(np.int32)).sum())
    return rv, rl


@pytest.mark.parametrize("seed", range(4))
def test_cull_bitwise_on_random_poses(seed):
    """visible, lod and area bitwise on 400 rotated, scaled items per pose;
    the poses reach both visibilities and several LODs."""
    rng = np.random.default_rng(seed)
    rv, rl = _assert_same(_random_case(rng, 400))
    assert rv.any() and not rv.all()
    assert len(np.unique(rl)) >= 3


def test_cull_bitwise_on_sponza():
    """Sponza's items (the port's own loader) under its camera at a few
    yaws and distances."""
    s = load_scene("Sponza", 192, 108)
    cam = s.cameras[0]
    nl = s.buffers.item_num_lods.astype(np.int32)
    lods = set()
    for yaw, back in ((0.0, 0.0), (60.0, 0.0), (-120.0, 300.0), (200.0, 900.0)):
        cam.yaw += yaw
        cam.position = np.asarray(cam.position, F32) - back * np.asarray(
            [1.0, 0.0, 0.0], F32)
        c = frame_constants_numpy(s.buffers, cam, s.lights)
        _, rl = _assert_same((c["world"], s.buffers.aabb_center,
                              s.buffers.aabb_extent, c["frustum_planes"],
                              c["view_proj"], nl))
        lods |= set(rl.tolist())
    assert len(lods) >= 2


def test_cull_near_plane():
    """Corners at and behind the camera plane (|w| <= 1e-9 takes w =
    1e-9): items centred on the eye plane, some with zero extent."""
    rng = np.random.default_rng(7)
    world, centers, extents, planes, vp, nl = _random_case(rng, 400)
    inv = np.linalg.inv(vp.astype(np.float64))
    # world points whose clip w is 0 (to f32 rounding)
    p = inv @ np.concatenate([rng.uniform(-1, 1, (400, 2)),
                              rng.uniform(0, 1, (400, 1)), np.zeros((400, 1))], 1).T
    p = p[:3] / np.where(np.abs(p[3]) > 1e-30, p[3], 1.0)
    world[:, :3, :3] = np.eye(3, dtype=F32)
    world[:, :3, 3] = p.T.astype(F32)
    centers[:] = 0.0
    extents[:100] = 0.0
    extents[100:200] = 1e-6
    case = (world, centers, extents, planes, vp, nl)
    hom = torch.cat([torch.from_numpy(world[:, :3, 3]), torch.ones(400, 1)], 1)
    w = (hom * torch.from_numpy(vp[3])).sum(1)
    assert int((w.abs() <= 1e-9).sum()) >= 10
    _assert_same(case)


def _find_thresholds() -> list:
    """t_j for j = 0..6 by bisection over f32 bit patterns: the smallest
    f32 area whose reference LOD is at most j (8 LODs allowed)."""
    nl = np.full(1, 8, np.int32)
    out = []
    for j in range(7):
        lo = int(np.array(F32(10.0 ** -(j + 1)) * F32(0.5)).view(np.int32))
        hi = int(np.array(F32(10.0 ** -(j + 1)) * F32(2.0)).view(np.int32))
        while hi - lo > 1:
            mid = (lo + hi) // 2
            a = np.array([mid], np.int32).view(F32)
            if _ref_lod(a, nl)[0] <= j:
                hi = mid
            else:
                lo = mid
        out.append(hi)
    return out


def test_lod_thresholds_are_the_references():
    assert tuple(_find_thresholds()) == culling.LOD_AREA_THRESHOLD_BITS


def test_lod_on_both_sides_of_each_threshold():
    """At t_j and nextafter(t_j, 0), and over 3000 ulps each side of every
    t_j (the thresholds assume the reference's LOD is monotone there), with
    the mesh's LOD count from 1 to 8, plus 0, subnormals, 1e-30 and
    below, 4, inf and NaN."""
    bits = np.asarray(culling.LOD_AREA_THRESHOLD_BITS, np.int64)
    sweep = (bits[:, None] + np.arange(-3000, 3001)[None, :]).reshape(-1)
    special = np.array([0.0, 1e-45, 1e-38, 1e-31, 1e-30, 1e-29, 4.0, 1e30,
                        np.inf, np.nan], F32)
    area = np.concatenate([sweep.astype(np.int32).view(F32), special])
    t = culling.lod_area_thresholds().numpy()
    assert np.array_equal(np.nextafter(t, F32(0)).view(np.int32), bits - 1)
    for n in range(1, 9):
        nl = np.full(area.shape, n, np.int32)
        assert np.array_equal(_ref_lod(area, nl), _port_lod(area, nl)), n
