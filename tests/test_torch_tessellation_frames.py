"""Tessellated frames of the port against the JAX package on the CPU, at
96x54: the Terrain level cut to 16 quad patches, and the StressTest level
cut to 24 animated objects with its TessRock, over two frames of its
animation. The reference runs op by op (its raster kernels compiled
whole, test_torch_slice.compiled_rasters), its shadow maps built view by
view as graph.render_shadow_maps builds them (that function runs
lax.scan, which would compile the front end whole); the port renders its
own maps. Each side loads its scene with its own host modules.

The frames live in a file of their own with two tests: pytest-xdist's
loadfile scheduling hands out files by their number of tests, largest
first, so this file runs beside the lane's longest file
(tests/test_capacity.py) rather than ahead of it. The functions and the
front end are checked in tests/test_torch_tessellation.py.

Tolerances: tri_id and motion equal; ldr within 3e-4 (the reference's
multichip bar, tests/test_multichip.py:73)."""
import types

import jax.numpy as jnp
import numpy as np
import torch
from threadpoolctl import threadpool_limits

from test_torch_slice import compiled_rasters
from test_torch_tessellation import (CPU, JAX, PORT, W, H, assert_bitwise,
                                     terrain_scene)
from vqengine_tpu.ops import shadow as js
from vqengine_tpu.render import graph as jg
from vqengine_tpu.render.renderer import VQRendererTPU
from vqengine_tpu_torch.engine.frame_loop import FrameLoop
from vqengine_tpu_torch.engine.scene_load import LoadedScene, find_data_dirs
from vqengine_tpu_torch.render.renderer import VQRendererTorch

torch.set_num_threads(1)

LDR_TOL = 3e-4


def ref_shadow_maps(scene, c, dims) -> dict:
    """The reference's ESM maps of every caster view, each view op by op
    (render_shadow_depth with its K2 compiled), pooled and cast as
    graph.render_shadow_maps does."""
    def depth(vp, size):
        with compiled_rasters():
            return js.render_shadow_depth(scene.positions, scene.item_of_vertex,
                                          c.world, vp, scene.indices, size)
    maps = {}
    sc, pc = c.spot_caster_vps.shape[0], c.point_caster_vps.shape[0]
    if sc:
        d = jnp.stack([depth(c.spot_caster_vps[i], dims[0]) for i in range(sc)])
        maps["spot"] = js.prefilter_esm(d, pool=1).astype(jnp.bfloat16)
    if pc:
        nf = np.asarray(c.point_caster_range)
        faces = jnp.stack([js.ndc_depth_to_radial(
            depth(c.point_caster_vps[k // 6, k % 6], dims[1]), nf[k // 6, 0], nf[k // 6, 1])
            for k in range(pc * 6)]).reshape(pc, 6, dims[1], dims[1])
        maps["point"] = js.prefilter_esm(faces, pool=2).astype(jnp.bfloat16)
    if c.dir_vp.shape[0]:
        maps["dir"] = js.prefilter_esm(depth(c.dir_vp[0], dims[2]),
                                       pool=1).astype(jnp.bfloat16)
    return maps


def assert_frames_match(out, ref, keys=()):
    ldr, ref_ldr = out["ldr"].numpy(), np.asarray(ref["ldr"])
    assert ldr.shape == (H, W, 3) and np.isfinite(ldr).all()
    np.testing.assert_array_equal(out["tri_id"].numpy(), np.asarray(ref["tri_id"]))
    np.testing.assert_allclose(ldr, ref_ldr, rtol=0, atol=LDR_TOL)
    for key in ("overflow", "pair_demand") + keys:
        assert_bitwise(out[key], np.asarray(ref[key]), key)


def test_terrain_frame_matches():
    """Terrain (augment_terrain(patches=4): 1,568 amplified triangles) from
    the level's camera, lit by its Stationary directional caster, whose
    maps (the terrain golden's shadow_dims (64, 64, 128)) are precomputed
    once as the engine caches them: the maps bitwise, then the frame."""
    dims = (64, 64, 128)
    jb, jcs, jl = terrain_scene(JAX)
    pb, pcs, pl = terrain_scene(PORT)
    r = VQRendererTorch(CPU)
    r.load_scene(pb)
    loop = FrameLoop(r, LoadedScene("Terrain", pb, pcs, pl, False, None, True), W, H,
                     flags={"shadow_dims": dims})
    assert loop.cache_shadow_maps
    out = loop.tick()
    jscene = jg.upload_scene(jb)
    jc = VQRendererTPU().build_frame_constants(jb, jcs[0], jl)
    maps = ref_shadow_maps(jscene, jc, dims)
    assert set(maps) == {"dir"}
    assert_bitwise(loop.static_maps["dir"].view(torch.int16),
                   np.asarray(maps["dir"]).view(np.int16), "dir map")
    with compiled_rasters():
        ref = jg.render_forward(jscene, jc, W, H, shadow_dims=dims, shadow_maps=maps)
    assert_frames_match(out, ref, ("object_id",))
    assert int((out["tri_id"] >= r.scene.num_tris_live).sum()) > 0.3 * W * H


def _stress(pkg):
    """StressTest with dims (2, 1, 5): 24 animated objects and the
    TessRock; its 80 gradient spheres left out (their LODs are most of the
    level's triangles) -> (SceneBuffers, cameras, lights, hook)."""
    rep = pkg.ser.parse_scene_file(find_data_dirs()[0] / "Levels" / "StressTest.xml")
    lib, meshes = {}, pkg.mesh.build_builtin_meshes()
    with threadpool_limits(limits=1):
        hook = pkg.scenes.augment_stress_test(rep, lib, dims=(2, 1, 5))
        rep.objects = [o for o in rep.objects
                       if not o.model.name.startswith("GradSphere")]
        buffers, cams, lights = pkg.sb.assemble_scene(rep, meshes, lib,
                                                      draw_light_gizmos=True)
    for c in cams:
        c.aspect = W / H
    return buffers, cams, lights, hook


def test_stress_frames_match():
    """Two StressTest frames with the animation advanced once (dt 1/60)
    between them, as the engine runs the level: the shadow maps rendered
    in each frame (spot, point and directional casters: a hook animates),
    MSAA 4x, motion vectors on the palette path (all 24 objects moved) and
    the TessRock's 12 tri patches amplified. ldr within 3e-4, tri_id,
    motion and the moved set equal, frame by frame."""
    dims = (64, 64, 64)
    flags = dict(shadow_dims=dims, msaa=True, enable_motion_vectors=True)
    pb, pcs, pl, ph = _stress(PORT)
    jb, jcs, jl, jh = _stress(JAX)
    assert pb.tpatch_corners.shape == (12, 3, 3)
    r = VQRendererTorch(CPU)
    r.load_scene(pb)
    loop = FrameLoop(r, LoadedScene("StressTest", pb, pcs, pl, False, None, True,
                                    update_hook=ph), W, H, flags=flags)
    assert not loop.cache_shadow_maps
    jscene = jg.upload_scene(jb)
    jengine = types.SimpleNamespace(scene_buffers=jb)
    prev = (None, None)
    for frame in range(2):
        if frame:
            loop.advance(1 / 60)
            jh(jengine, 1 / 60)
        out = loop.render()
        jc = VQRendererTPU().build_frame_constants(
            jb, jcs[0], jl, hdri_yaw=jh.hdri_yaw * 2.0 * np.pi,
            prev_world=prev[0], prev_view_proj=prev[1])
        moved = () if prev[0] is None else tuple(int(i) for i in np.flatnonzero(
            np.abs(np.asarray(jc.world) - prev[0]).max(axis=(1, 2)) > 1e-6))
        assert loop.dynamic_items == moved
        maps = ref_shadow_maps(jscene, jc, dims)
        assert set(maps) == {"spot", "point", "dir"}
        with compiled_rasters():
            ref = jg.render_forward(jscene, jc, W, H, shadow_maps=maps,
                                    dynamic_item_ids=moved, **flags)
        assert_frames_match(out, ref, ("motion",))
        prev = (np.asarray(jc.world), np.asarray(jc.view_proj))
    assert len(loop.dynamic_items) == 24
    assert float(np.abs(out["motion"].numpy()).max()) > 0
