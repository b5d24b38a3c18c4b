"""The benchmark's import guard: no JAX and no JAX package in a process
that measures the port."""
from __future__ import annotations

import sys

# top-level module names, compared whole: the port's name begins with the
# JAX package's
FORBIDDEN = ("jax", "jaxlib", "flax", "vqengine_tpu")


def forbidden_loaded(modules=None) -> list[str]:
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))

