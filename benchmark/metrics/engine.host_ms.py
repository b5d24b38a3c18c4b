"""Host ms per engine tick outside the renderer's render: events, input,
the update hook and the frame constants (the harness's spans around
VQEngineTorch.tick and VQRendererTorch.render, host clock, traced run)."""


def read(ctx):
    return ctx.get("host_ms")
