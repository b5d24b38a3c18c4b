"""Seconds from start_loading_scene to a level ready to tick, the
environment maps included (host clock, synchronized)."""


def read(ctx):
    return ctx.get("load_s")
