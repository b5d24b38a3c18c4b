"""Host ms a tick in the scene's update hook (the program's vq.tick.hook
span, around StressTest's animation)."""
from harness import spans


def read(ctx):
    return spans.host_ms("vq.tick.hook")
