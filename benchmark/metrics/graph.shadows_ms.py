"""Device ms a frame in the shadow pass (the maps rendered in the frame, and
the lookups): the program's vq.pass.* spans, each a CUDA event pair from the
device reaching the pass to its end."""
from harness import spans

PASSES = ("shadows",)


def read(ctx):
    return spans.device_ms("vq.pass." + p for p in PASSES)
