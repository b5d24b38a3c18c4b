"""K1-MSAA's share of its roofline: the least time of its launches in the
traced window (harness/roofline.py, from the frame's size and the scene's
triangle count) over their device time in the trace."""
import re

from harness import roofline, trace

NAME = re.compile(r"raster_gbuf_kernel<1,\s*false>")


def read(ctx):
    win = ctx.get("window")
    if win is None:
        return None
    ms, n = trace.matching(win.rows, NAME)
    if n == 0:
        return None
    tr = ctx["traffic"]
    bound = n * roofline.k1_msaa_bound_s(tr["width"], tr["height"],
                                         ctx["config"]["triangles"])
    return roofline.share_percent(bound, ms / 1e3)
