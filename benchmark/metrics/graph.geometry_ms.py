"""Device ms a frame in the geometry, material and alpha-mask peel passes:
the program's vq.pass.* spans, each a CUDA event pair from the device
reaching the pass to its end."""
from harness import spans

PASSES = ("geometry", "material", "alpha_peel")


def read(ctx):
    return spans.device_ms("vq.pass." + p for p in PASSES)
