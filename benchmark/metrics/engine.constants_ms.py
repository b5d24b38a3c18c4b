"""Host ms a tick building and uploading the frame constants and diffing
the moved items (the program's vq.frame.constants span)."""
from harness import spans


def read(ctx):
    return spans.host_ms("vq.frame.constants")
