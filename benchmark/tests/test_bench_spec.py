"""A configuration, a traffic mix, a cell and a per-layer metric are added
by new files and new entries in BENCHMARK.json alone."""
import json
import shutil

from harness import spec


def test_new_cell_mix_and_metric_by_files(tmp_path):
    bench = tmp_path / "benchmark"
    shutil.copytree(spec.ROOT, bench, ignore=shutil.ignore_patterns(
        "reference", "tests", "__pycache__"))
    s = spec.load_spec()
    (bench / "configs" / "terrain.json").write_text(json.dumps(
        {"level": "Terrain", "graphics": {}, "triangles": 56448,
         "shadow_views": {}}))
    (bench / "traffic" / "autotest-1080p.json").write_text(json.dumps(
        {"width": 1920, "height": 1080}))
    (bench / "limits" / "terrain-1080p-autotest.json").write_text(
        json.dumps({"ldr_mean_gap": 1e-5}))
    (bench / "metrics" / "graph.frames.py").write_text(
        "def read(ctx):\n    return ctx['frames']\n")
    s["configs"].append({"name": "terrain", "source": "x",
                         "file": "benchmark/configs/terrain.json",
                         "reduced": [], "why": "x"})
    s["workloads"].append({"name": "terrain-1080p-autotest", "config": "terrain",
                           "traffic": "autotest-1080p", "chips": 1, "why": "x"})
    s["per_layer"].append({"name": "graph.frames", "unit": "frames",
                           "better": "higher", "source": "program_counter",
                           "layer": "render graph", "moves": "frame_ms",
                           "workloads": ["terrain-1080p-autotest"]})
    c = spec.cell("terrain-1080p-autotest", s, root=bench)
    assert c.config["level"] == "Terrain" and c.config["name"] == "terrain"
    assert c.traffic["width"] == 1920 and c.traffic["name"] == "autotest-1080p"
    assert c.limits == {"ldr_mean_gap": 1e-5}
    names = [m["name"] for m in c.per_layer]
    assert "graph.frames" in names
    # a metric listing other cells is not this cell's
    assert "kernels.k2_roofline" not in names
    assert spec.reader("graph.frames", root=bench)({"frames": 7}) == 7
    # the cells already there are as they were
    old = spec.cell("sponza-4k-autotest", s, root=bench)
    assert "graph.frames" not in [m["name"] for m in old.per_layer]


def test_every_cell_resolves():
    s = spec.load_spec()
    for w in s["workloads"]:
        c = spec.cell(w["name"], s)
        assert c.limits, f"{w['name']} has no correctness limits"
        assert {m["name"] for m in c.end_to_end} >= {"setup_s", "frame_ms"}
        for m in c.per_layer:
            assert callable(spec.reader(m["name"]))
