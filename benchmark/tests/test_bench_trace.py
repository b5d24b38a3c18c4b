"""The device's busy time is the union of its operations in the window."""
import json

import pytest

from harness import trace


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def events():
    return [
        ev("user_annotation", "window", 100.0, 1000.0),
        ev("user_annotation", "tick", 100.0, 500.0),
        ev("cpu_op", "aten::item", 300.0, 150.0),
        ev("kernel", "k_a", 50.0, 100.0),        # clipped to [100, 150)
        ev("kernel", "k_b", 120.0, 80.0),        # overlaps k_a: union
        ev("gpu_memcpy", "copy", 500.0, 100.0),
        ev("gpu_memset", "set", 1050.0, 200.0),  # clipped to [1050, 1100)
        ev("kernel", "outside", 2000.0, 10.0),
        ev("cpu_op", "aten::add", 700.0, 10.0),  # host, not device
    ]


def test_union_clipped_to_window(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events()}))
    w = trace.window(trace.load(path), "window")
    assert w.ms == pytest.approx(1.0)
    # [100, 200) + [500, 600) + [1050, 1100) us
    assert w.busy_ms == pytest.approx(0.25)
    assert w.ops == 3                       # started inside the window
    assert w.rows["k_a"] == [pytest.approx(0.05), 1]
    assert "outside" not in w.rows


def test_gaps_longest_first_with_host_labels():
    w = trace.window(events(), "window")
    lengths = [ms for ms, _ in w.gaps]
    assert lengths == sorted(lengths, reverse=True)
    assert lengths[0] == pytest.approx(0.45)   # [600, 1050)
    # the gap [200, 500) starts while the tick span runs, in no host op
    # at 201 us; the labels name the innermost span and op at the gap
    labels = dict((round(ms, 3), label) for ms, label in w.gaps)
    assert labels[0.3] == "tick"
    assert labels[0.45] == "window"


def test_matching_sums_by_pattern():
    import re
    rows = {"void raster_gbuf_kernel<1, false>(float const*)": [2.0, 2],
            "void raster_gbuf_kernel<0, false>(float const*)": [1.0, 1]}
    assert trace.matching(rows, re.compile(r"raster_gbuf_kernel<1,\s*false>")) \
        == (2.0, 2)
    assert trace.top_ops(rows, 1) == [[
        "void raster_gbuf_kernel<1, false>(float const*)", 0.002]]
