"""Device operations (kernels, memcpys, memsets) a frame: those that
started in the traced window over its frames."""


def read(ctx):
    win = ctx.get("window")
    if win is None or win.ops == 0:
        return None
    return win.ops / ctx["frames"]
