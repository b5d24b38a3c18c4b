"""Reading a torch.profiler chrome trace: the device's busy time in a host
annotation's window, its operations by name, and its longest idle gaps
with what the host was doing in each."""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime")


@dataclass
class Window:
    ms: float                  # the annotation's length
    busy_ms: float             # union of device operations inside it
    ops: int                   # device operations that started inside it
    rows: dict                 # name -> [ms, count], clipped to the window
    gaps: list = field(default_factory=list)   # [(ms, label)], longest first
    names: dict = field(default_factory=dict)  # annotation name -> count


def load(path: Path) -> list[dict]:
    with open(path) as f:
        trace = json.load(f)
    return [e for e in trace["traceEvents"] if e.get("ph") == "X"]


def window(events: list[dict], name: str, n_gaps: int = 10) -> Window:
    """The first host annotation `name`: its length, and the union of the
    kernel, memcpy and memset intervals on the device clipped to it (the
    busy time; as the smoke's idle_share)."""
    win = next(e for e in events if e.get("cat") == "user_annotation"
               and e["name"] == name)
    w0, w1 = win["ts"], win["ts"] + win["dur"]
    spans, rows, ops = [], {}, 0
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a, b = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if w0 <= e["ts"] < w1:
            ops += 1
        if b <= a:
            continue
        spans.append((a, b))
        r = rows.setdefault(e["name"], [0.0, 0])
        r[0] += (b - a) / 1e3
        r[1] += 1
    busy, end, gaps = 0.0, w0, []
    for a, b in sorted(spans):
        if a > end:
            gaps.append((end, a))
        a = max(a, end)
        if b > a:
            busy += b - a
            end = b
    if w1 > end:
        gaps.append((end, w1))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:n_gaps]
    names = {}
    for e in events:
        if e.get("cat") == "user_annotation" and w0 <= e["ts"] < w1:
            names[e["name"]] = names.get(e["name"], 0) + 1
    return Window((w1 - w0) / 1e3, busy / 1e3, ops, rows,
                  [((b - a) / 1e3, _label(events, a, b)) for a, b in gaps],
                  names)


def _label(events: list[dict], a: float, b: float) -> str:
    """What the host was doing at the start of a device gap: the
    innermost annotation (the harness's spans) and the innermost host
    operation running then."""
    t = a + min(1.0, (b - a) / 2)
    span, op = None, None
    for e in events:
        cat = e.get("cat")
        if cat not in HOST_CATS or not e["ts"] <= t < e["ts"] + e["dur"]:
            continue
        if cat == "user_annotation":
            if span is None or e["dur"] < span["dur"]:
                span = e
        elif op is None or e["dur"] < op["dur"]:
            op = e
    parts = [x["name"] for x in (span, op) if x is not None]
    return " > ".join(parts) if parts else "host (no traced operation)"


def top_ops(rows: dict, n: int = 10) -> list:
    """[[name, seconds]] of the n device operations that took most time."""
    best = sorted(rows.items(), key=lambda kv: -kv[1][0])[:n]
    return [[k[:200], v[0] / 1e3] for k, v in best]


def matching(rows: dict, pattern) -> tuple[float, int]:
    """(ms, launches) of the device operations whose name matches."""
    ms, n = 0.0, 0
    for k, (t, c) in rows.items():
        if pattern.search(k):
            ms += t
            n += c
    return ms, n
