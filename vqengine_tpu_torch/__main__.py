"""Command line: ``python -m vqengine_tpu_torch [-Test] [-TestFrames=N]
[-W= -H= -Scene= -OutputDir= ...]`` runs the port's engine on the card,
with the JAX package's CLI contract (the reference VQE.exe's,
Main.cpp:38-229): exit code 0 on success, nonzero on failure (1 when the
engine fails or no scene loads, 2 for a non-finite frame, 3 for a bin
overflow), as Scripts/TestVQE.bat checks %errorlevel%.

There is no CPU fallback: without a CUDA device the run fails. A caller
that wants the CPU (the tests) passes it: ``main(argv,
device=torch.device("cpu"))``.
"""
from __future__ import annotations

import sys


def main(argv: list[str] | None = None, device=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    try:
        from .engine.engine import VQEngineTorch
        engine = VQEngineTorch(argv, device=device)
        return engine.run()
    except Exception as e:  # noqa: BLE001
        print(f"[E] fatal: {e}", file=sys.stderr)
        import traceback
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main())
