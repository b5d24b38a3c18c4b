"""The port's benchmark: one run of one cell of BENCHMARK.json.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the run's result as the last line of standard output (one JSON
object) and the numbers the correctness check compared, each beside its
limit, as the last lines of standard error. Exits non-zero, with no
result, without a CUDA card (or with fewer than the cell asks for), or if
JAX or the JAX package was imported.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
sys.path[:0] = [str(HERE), str(CHECKOUT)]
os.environ.setdefault("USE_FLAX", "0")

from harness import guard, spec  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    os.chdir(CHECKOUT)                   # the engine finds ./Data
    from harness import report
    if cell.chips != 1:
        print(f"{args.workload}: no runner for {cell.chips} cards",
              file=sys.stderr)
        return 2
    from harness import engine_cell
    res = engine_cell.run(cell, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda", 0), T0)
    print(f"[bench] {args.workload}: set-up {res['setup_s']:.1f} s (level "
          f"{res['load_s']:.1f} s), {res['frames']} frames in the window",
          file=sys.stderr)
    line, checks = report.result(cell, res, bool(args.trace))
    bad = guard.forbidden_loaded()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    print(json.dumps(line))
    for name, (value, limit) in checks.items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
