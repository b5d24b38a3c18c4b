"""The run's result line: the check against the reference, the metrics
(end-to-end without trace, per-layer with), the device and, with trace,
the breakdown."""
from __future__ import annotations

import math
import sys
import time

import torch

from . import check, spec, trace as trace_mod


def judge(cell, res) -> tuple[bool, dict]:
    from reference.level import Level
    tr = cell.traffic
    t = time.perf_counter()
    level = Level(cell.config["level"], tr["width"], tr["height"],
                  res["device"], env_sizes=res.get("env_sizes"))
    t_load = time.perf_counter() - t
    worst = check.judge(res["captures"], level)
    del level
    print(f"[bench] reference: level {t_load:.1f} s, frames "
          f"{time.perf_counter() - t - t_load:.1f} s", file=sys.stderr)
    ok, checks = check.verdict(worst, cell.limits)
    rest = {k: v for k, v in worst.items() if k not in checks}
    if rest:
        print(f"[bench] not compared: {rest}", file=sys.stderr)
    return ok and res["failed"] == 0, checks


def result(cell, res: dict, traced: bool) -> tuple[dict, dict]:
    correct, checks = judge(cell, res)
    metrics = {}
    if not traced:
        values = {"frame_ms": res["frame_ms"],
                  "frame_ms_p90": res["frame_ms_p90"],
                  "peak_mem_mib": res["peak_bytes"] / 2 ** 20,
                  "setup_s": res["setup_s"]}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        ctx = dict(res, cell=cell, config=cell.config, traffic=cell.traffic)
        for m in cell.per_layer:
            v = spec.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = res["device"]
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
              "count": cell.chips,
              "memory_peak_bytes": int(res["peak_bytes"])}
    line = {"correct": bool(correct), "attempted": int(res["frames"]),
            "failed": int(res["failed"]), "metrics": metrics,
            "device": device}
    if traced:
        win = res["window"]
        device["busy_s"] = res["busy_ms"] / 1e3
        device["window_s"] = res["window_ms"] / 1e3
        line["breakdown"] = {
            "device_ops": trace_mod.top_ops(win.rows),
            "idle_gaps": [[label[:200], ms / 1e3] for ms, label in win.gaps]}
    # JSON has no infinity: a number that is not finite is written as text
    line["checks"] = {k: [v if math.isfinite(v) else str(v), lim]
                      for k, (v, lim) in checks.items()}
    return line, checks
