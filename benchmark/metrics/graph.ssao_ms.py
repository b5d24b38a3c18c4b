"""Device ms a frame in the SSAO pass (with the half-size depth that SSR
shares): the program's vq.pass.* spans, each a CUDA event pair from the
device reaching the pass to its end."""
from harness import spans

PASSES = ("ssao",)


def read(ctx):
    return spans.device_ms("vq.pass." + p for p in PASSES)
