"""Device ms a frame in the tonemap and the post chain's tail (CAS, FSR1):
the program's vq.pass.* spans, each a CUDA event pair from the device
reaching the pass to its end."""
from harness import spans

PASSES = ("tonemap", "tail")


def read(ctx):
    return spans.device_ms("vq.pass." + p for p in PASSES)
