"""Device ms a frame in motion vectors, the environment term, shading, the
MSAA edge resolve, the sky and the transparent pass: the program's vq.pass.*
spans, each a CUDA event pair from the device reaching the pass to its end."""
from harness import spans

PASSES = ("motion", "environment", "shade", "edge_resolve", "sky",
          "transparent")


def read(ctx):
    return spans.device_ms("vq.pass." + p for p in PASSES)
