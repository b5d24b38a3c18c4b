"""The port's tracer (vqengine_tpu_torch/utils/trace.py): spans and sync
counts recorded only while torch.profiler records, the render graph's
passes in frame order under vq.render, every binning read counted at its
site, the benchmark's readers of them; and, on a card, that every
synchronization of the engine's tick has a site.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_trace.py -q
    python -m pytest --noconftest tests/test_torch_trace.py -q -m gpu   # card
"""
from __future__ import annotations

import collections
import functools
import importlib.util
import json
import sys
import warnings
from pathlib import Path

import pytest
import torch

from vqengine_tpu_torch.engine.cli import parse_command_line
from vqengine_tpu_torch.engine.engine import VQEngineTorch
from vqengine_tpu_torch.entry import tiny_scene_numpy
from vqengine_tpu_torch.ops import raster
from vqengine_tpu_torch.render import graph
from vqengine_tpu_torch.render.renderer import (VQRendererTorch,
                                                frame_constants_numpy)
from vqengine_tpu_torch.utils import trace

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parent.parent
CPU_ONLY = [torch.profiler.ProfilerActivity.CPU]

# the vq.pass.* spans in the order render_forward opens them
PASS_ORDER = ("geometry", "material", "alpha_peel", "ssao", "motion",
              "shadows", "environment", "shade", "edge_resolve", "sky", "ssr",
              "transparent", "tonemap", "tail")


@pytest.fixture(autouse=True)
def fresh_tracer():
    trace.reset()
    yield
    trace.reset()


def small_engine():
    """HelloCube at 96x64 on the CPU, the costly passes off."""
    e = VQEngineTorch(startup=parse_command_line(
        ["-W=96", "-H=64", "-Scene=HelloCube"]), device=CPU)
    e.gfx.bAmbientOcclusion = False
    e.gfx.bAntiAliasing = False
    e.gfx.Reflections = 0
    e._build_environment_maps = functools.partial(
        VQEngineTorch._build_environment_maps, e, diffuse_size=4,
        specular_base=8, lut_size=16)
    assert e.start_loading_scene("HelloCube")
    return e


def test_off_without_profiler(monkeypatch):
    """No profiler: a tick enters no record_function, makes no CUDA event
    and records nothing; every span and site is the one shared no-op."""
    e = small_engine()
    e.tick()
    calls = collections.Counter()

    def counting(name):
        def fail(*a, **kw):
            calls[name] += 1
            raise AssertionError(f"{name} called with tracing off")
        return fail
    monkeypatch.setattr(torch.profiler, "record_function",
                        counting("record_function"))
    monkeypatch.setattr(torch.cuda, "Event", counting("Event"))
    e.tick()
    assert not calls
    assert trace.summary() == {"ticks": 0, "spans": {}, "syncs": {}}
    assert trace.span("vq.x", CPU) is trace.blocking("x") is trace.tick()


def annotations(prof, tmp_path) -> list:
    """The profiler's vq.* annotations as (start, end, name), by start."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("cat") == "user_annotation"
                  and e["name"].startswith("vq."))


def within(inner, outer) -> bool:
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def test_render_spans_in_frame_order(tmp_path):
    """One render of the entry scene with MSAA, SSAO, motion vectors, SSR,
    a shadow map drawn in the frame and the tail: the profiler exports the
    vq.pass.* spans in frame order inside vq.render, the raster front
    end, binning and K1 inside vq.pass.geometry and the shadow view's K2
    inside vq.pass.shadows; the tracer holds the same tree."""
    buffers, cam, lights = tiny_scene_numpy(64, 32)
    lights[0].casts_shadows = True
    r = VQRendererTorch(CPU)
    r.load_scene(buffers)
    consts = r.build_frame_constants(buffers, cam, lights)
    with torch.profiler.profile(activities=CPU_ONLY) as prof:
        r.render(consts, 64, 32, readback=False, msaa=True, enable_ssao=True,
                 enable_motion_vectors=True, enable_ssr=True,
                 cas_sharpness=0.5, shadow_dims=(32, 32, 32))
    spans = annotations(prof, tmp_path)
    render = [s for s in spans if s[2] == "vq.render"]
    assert len(render) == 1
    passes = [s for s in spans if s[2].startswith("vq.pass.")]
    names = [s[2][len("vq.pass."):] for s in passes]
    assert names == [p for p in PASS_ORDER
                     if p not in ("alpha_peel", "transparent")]
    assert all(within(p, render[0]) for p in passes)
    assert all(a[1] <= b[0] for a, b in zip(passes, passes[1:]))
    of = {s[2]: s for s in passes}
    raster_spans = [s for s in spans if s[2].startswith("vq.raster.")]
    geo = [s[2] for s in raster_spans if within(s, of["vq.pass.geometry"])]
    shad = [s[2] for s in raster_spans if within(s, of["vq.pass.shadows"])]
    assert geo == ["vq.raster.setup", "vq.raster.bin", "vq.raster.k1"]
    assert shad == ["vq.raster.setup", "vq.raster.bin", "vq.raster.k2"]
    assert len(raster_spans) == len(geo) + len(shad)
    # the tracer's own records: each pass's parent is vq.render
    recs = trace.TRACER.spans
    top = [i for i, r_ in enumerate(recs) if r_[0] == "vq.render"]
    assert len(top) == 1
    assert [r_[0] for r_ in recs if r_[1] == top[0]] == [s[2] for s in passes]
    s = trace.summary()
    assert s["ticks"] == 0 and s["spans"]["vq.pass.geometry"]["count"] == 1
    assert s["spans"]["vq.pass.geometry"]["device_ms"] is None   # no card


def test_binning_counts_every_site():
    """One binning and its group sequences (the plain rasters' table):
    each blocking read counted at its site, in one vq.raster.bin span."""
    buffers, cam, lights = tiny_scene_numpy(64, 32)
    scene = graph.upload_scene(buffers, CPU, bucketize=False)
    consts = graph.frame_constants_from_numpy(
        frame_constants_numpy(buffers, cam, lights), CPU)
    setup, extra = graph.geometry_setup_gbuf(scene, consts, 64, 32)
    with torch.profiler.profile(activities=CPU_ONLY):
        binned = raster.bin_triangles(setup, 64, 32, extra=extra)
        raster._group_sequences(binned)
    s = trace.summary()
    counts = {site: v["count"] for site, v in s["syncs"].items()}
    assert counts == {"raster.killed_record": 4, "raster.bin.pairs": 1,
                      "raster.bin.bincount": 2, "raster.bin.nonzero": 1,
                      "raster.bin.globals": 1, "raster.bin.upload": 3,
                      "raster.group.globals": 1, "raster.group.length": 1}
    assert all(v["wait_ms"] >= 0.0 for v in s["syncs"].values())
    assert s["spans"]["vq.raster.bin"]["count"] == 1


METRICS = ROOT / "benchmark" / "metrics"
SUMMARY = {"ticks": 4, "spans": {
    "vq.tick": {"count": 4, "host_ms": 400.0, "device_ms": None},
    "vq.tick.hook": {"count": 4, "host_ms": 120.0, "device_ms": None},
    "vq.frame.constants": {"count": 4, "host_ms": 80.0, "device_ms": None},
    "vq.render": {"count": 4, "host_ms": 200.0, "device_ms": 1000.0},
    **{f"vq.pass.{p}": {"count": 4, "host_ms": 1.0, "device_ms": 4.0 * (i + 1)}
       for i, p in enumerate(PASS_ORDER)}},
    "syncs": {"a": {"count": 40, "wait_ms": 8.0},
              "b": {"count": 12, "wait_ms": 2.0}}}
EXPECTED = {"engine.hook_ms": 30.0, "engine.constants_ms": 20.0,
            "graph.host_syncs": 13.0, "graph.sync_wait_ms": 2.5,
            "graph.geometry_ms": 1 + 2 + 3, "graph.ssao_ms": 4,
            "graph.shadows_ms": 6, "graph.ssr_ms": 11,
            "graph.shading_ms": 5 + 7 + 8 + 9 + 10 + 12,
            "graph.post_ms": 13 + 14}


def reader(name: str):
    sys.path.insert(0, str(ROOT / "benchmark"))
    try:
        spec = importlib.util.spec_from_file_location(
            "metric_" + name.replace(".", "_"), METRICS / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(str(ROOT / "benchmark"))
    return mod.read


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_metric_reads_the_tracer(name, monkeypatch):
    """Each reader from a fixed summary; None where the program has no
    tracer (the parent's tree) or it recorded no tick."""
    read = reader(name)
    monkeypatch.setattr(trace, "summary", lambda: SUMMARY)
    assert read({}) == pytest.approx(EXPECTED[name])
    monkeypatch.setattr(trace, "summary",
                        lambda: {"ticks": 0, "spans": {}, "syncs": {}})
    assert read({}) is None
    monkeypatch.setitem(sys.modules, "vqengine_tpu_torch.utils.trace", None)
    assert read({}) is None


def test_pass_metrics_cover_every_pass():
    """The six graph.*_ms groups hold every vq.pass.* span once."""
    groups = [reader(f"graph.{g}_ms").__globals__["PASSES"]
              for g in ("geometry", "shadows", "ssao", "ssr", "shading",
                        "post")]
    flat = [p for g in groups for p in g]
    assert sorted(flat) == sorted(PASS_ORDER)


@pytest.mark.gpu
@pytest.mark.parametrize("level,views", [("Sponza", False),
                                         ("StressTest", False),
                                         ("Sponza", True)])
def test_every_sync_has_a_site(level, views):
    """On the card, under the sync debug mode: the synchronizations of a
    few ticks (Sponza's cached maps, StressTest's hook and 8 views a
    frame; with views, PCF shadows and the debug views: a draw mode, the
    outline and the magnifier) equal the tracer's count over its sites.
    Only the ticks' warnings count (switching the mode on can surface one
    of its own)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    e = VQEngineTorch(["-W=640", "-H=360"], device=torch.device("cuda"))
    assert e.start_loading_scene(level)
    if views:
        e.gfx.ShadowFilter = "pcf"
        e.draw_mode = 1
        e.selected_object = 2
        e.magnifier_on = True
    for _ in range(2):
        e.tick()
    torch.cuda.synchronize()
    trace.reset()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with torch.profiler.profile(activities=CPU_ONLY):
            torch.cuda.set_sync_debug_mode("warn")
            caught.clear()
            try:
                for _ in range(3):
                    e.tick()
            finally:
                torch.cuda.set_sync_debug_mode(0)
    where = collections.Counter(
        f"{Path(w.filename).name}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message))
    s = trace.summary()
    counted = {site: v["count"] for site, v in s["syncs"].items()}
    assert s["ticks"] == 3
    assert sum(where.values()) == sum(counted.values()), (where, counted)
