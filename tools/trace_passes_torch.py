"""Where a tick's device time goes, pass by pass, on one CUDA card: runs
the engine's tick (engine.VQEngineTorch, the level's camera 0, no input)
under torch.profiler with CPU and CUDA activity, then charges every
kernel, memcpy and memset of the exported chrome trace to the program's
span that launched it: the innermost vq.* annotation on the launching
thread at the launch's time, matched to the device operation by the
launch's correlation id, and the innermost aten op there.

    python3 tools/trace_passes_torch.py Sponza --size 3840x2160 --ticks 4 \\
        --out passes_sponza.txt

Prints, a tick: each pass's (vq.pass.*) device ms as the sum of its
operations' durations and its launches; the costliest device operations
with the pass, the innermost span and the aten op that launched each; and
the program's tracer summary (utils/trace.summary(): each span's
event-pair device ms and host ms, the blocking reads by site); --out also
writes them to a file.
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from vqengine_tpu_torch.engine.engine import VQEngineTorch  # noqa: E402
from vqengine_tpu_torch.utils import trace  # noqa: E402

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def innermost(intervals: list, points: list) -> dict:
    """intervals [(start, end, name)], properly nested; points [(t, key)]
    -> {key: the name of the innermost interval holding t, or None}."""
    iv = sorted(intervals, key=lambda x: (x[0], -x[1]))
    out, stack, i = {}, [], 0
    for t, key in sorted(points):
        while i < len(iv) and iv[i][0] <= t:
            while stack and stack[-1][1] <= iv[i][0]:
                stack.pop()
            stack.append(iv[i])
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out[key] = stack[-1][2] if stack else None
    return out


def charge(events: list) -> list:
    """[(pass, span, op, device operation, ms)] for every device operation
    whose launch the trace holds."""
    launch = {}
    by_tid = collections.defaultdict(lambda: ([], [], []))
    for e in events:
        cat, tid = e.get("cat"), e.get("tid")
        if cat == "cuda_runtime" and "correlation" in e.get("args", {}):
            launch[e["args"]["correlation"]] = e
            by_tid[tid][2].append((e["ts"], e["args"]["correlation"]))
        elif cat == "user_annotation" and e["name"].startswith("vq."):
            iv = (e["ts"], e["ts"] + e["dur"], e["name"])
            by_tid[tid][0].append(iv)
        elif cat == "cpu_op":
            by_tid[tid][1].append((e["ts"], e["ts"] + e["dur"], e["name"]))
    span_of, pass_of, op_of = {}, {}, {}
    for spans, ops, points in by_tid.values():
        span_of.update(innermost(spans, points))
        pass_of.update(innermost([s for s in spans
                                  if s[2].startswith("vq.pass.")], points))
        op_of.update(innermost(ops, points))
    rows = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        c = e.get("args", {}).get("correlation")
        if c not in launch:
            continue
        rows.append((pass_of.get(c), span_of.get(c), op_of.get(c), e["name"],
                     e["dur"] / 1e3))
    return rows


def tables(rows: list, ticks: int, top: int = 25) -> str:
    lines = ["pass                      device ms/tick  launches/tick"]
    per_pass = collections.defaultdict(lambda: [0.0, 0])
    for p, _, _, _, ms in rows:
        per_pass[p][0] += ms
        per_pass[p][1] += 1
    for p, (ms, n) in sorted(per_pass.items(), key=lambda kv: -kv[1][0]):
        lines.append(f"{str(p):26s}{ms / ticks:14.3f}{n / ticks:15.1f}")
    lines += ["", "device ms/tick  launches/tick  pass | span | aten op | "
              "device operation"]
    per_op = collections.defaultdict(lambda: [0.0, 0])
    for p, s, op, name, ms in rows:
        per_op[(p, s, op, name)][0] += ms
        per_op[(p, s, op, name)][1] += 1
    for (p, s, op, name), (ms, n) in sorted(
            per_op.items(), key=lambda kv: -kv[1][0])[:top]:
        lines.append(f"{ms / ticks:14.3f}{n / ticks:15.1f}  {p} | {s} | {op} "
                     f"| {name[:90]}")
    return "\n".join(lines)


def summary_table(s: dict) -> str:
    n = max(s["ticks"], 1)
    lines = [f"tracer: {s['ticks']} ticks", "span  host ms/tick  device ms/tick"
             "  count/tick"]
    for name, v in s["spans"].items():
        dev = ("-" if v["device_ms"] is None
               else f"{v['device_ms'] / n:.3f}")
        lines.append(f"{name}  {v['host_ms'] / n:.3f}  {dev}  "
                     f"{v['count'] / n:.2f}")
    lines.append("sync site  syncs/tick  wait ms/tick")
    for site, v in sorted(s["syncs"].items(), key=lambda kv: -kv[1]["count"]):
        lines.append(f"{site}  {v['count'] / n:.2f}  {v['wait_ms'] / n:.3f}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("level")
    ap.add_argument("--size", default="3840x2160")
    ap.add_argument("--ticks", type=int, default=4)
    ap.add_argument("--warmup", type=int, default=4)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    w, h = (int(v) for v in args.size.split("x"))
    engine = VQEngineTorch([f"-W={w}", f"-H={h}"], device=torch.device("cuda"))
    if not engine.start_loading_scene(args.level):
        return 1
    for _ in range(args.warmup):
        engine.tick()
    torch.cuda.synchronize()
    trace.reset()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(args.ticks):
            engine.tick()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"]
                      if e.get("ph") == "X"]
    text = (f"{args.level} {w}x{h}, {args.ticks} ticks on "
            f"{torch.cuda.get_device_name(0)}\n"
            + tables(charge(events), args.ticks) + "\n\n"
            + summary_table(trace.summary()))
    print(text)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
