"""What a cell is made of, found by name.

BENCHMARK.json names the cell; its configuration is the file the config
entry names, its traffic mix is traffic/<traffic>.json, its correctness
limits are limits/<cell>.json, and each per-layer metric is read by
metrics/<metric name>.py. A new configuration, mix, metric or cell is new
files and entries; nothing here changes.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent        # benchmark/
CHECKOUT = ROOT.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration's file, with its entry's name
    traffic: dict         # traffic/<traffic>.json, with its name
    limits: dict          # limits/<cell>.json: {number: limit}
    end_to_end: list      # BENCHMARK.json metric entries this cell reports
    per_layer: list


def load_spec(path: Path | None = None) -> dict:
    return json.loads((path or CHECKOUT / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, spec: dict | None = None, root: Path = ROOT) -> Cell:
    spec = spec or load_spec()
    w = next((w for w in spec["workloads"] if w["name"] == name), None)
    if w is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    centry = next(c for c in spec["configs"] if c["name"] == w["config"])
    config = json.loads((root.parent / centry["file"]).read_text())
    config["name"] = centry["name"]
    traffic = json.loads((root / "traffic" / f"{w['traffic']}.json").read_text())
    traffic["name"] = w["traffic"]
    limits_file = root / "limits" / f"{name}.json"
    limits = json.loads(limits_file.read_text()) if limits_file.is_file() else {}
    e2e = [m for m in spec["end_to_end"] if _reports(m, name)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if _reports(m, name) and m["moves"] in names]
    return Cell(name, int(w["chips"]), config, traffic, limits, e2e, per_layer)


def reader(metric: str, root: Path = ROOT):
    """metrics/<metric>.py's read(ctx) -> a number, or None where the run
    has nothing for it to read."""
    path = root / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
