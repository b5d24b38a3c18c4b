"""K2's (the centre-sampled visibility raster's) share of its roofline
over the shadow views rendered in the traced window: the least time of
each frame's views (harness/roofline.py, from the configuration's view
sizes and the scene's triangle count) over their device time."""
import re

from harness import roofline, trace

NAME = re.compile(r"raster_vis_kernel<0>")


def read(ctx):
    win = ctx.get("window")
    if win is None:
        return None
    ms, n = trace.matching(win.rows, NAME)
    views = ctx["config"]["shadow_views"]
    per_frame = sum(int(v["count"]) for v in views.values())
    if n == 0 or per_frame == 0:
        return None
    if n % per_frame:
        raise RuntimeError(f"{n} K2 launches are not whole frames of "
                           f"{per_frame} views")
    tris = ctx["config"]["triangles"]
    bound = (n // per_frame) * sum(
        int(v["count"]) * roofline.k2_bound_s(int(v["size"]), tris)
        for v in views.values())
    return roofline.share_percent(bound, ms / 1e3)
