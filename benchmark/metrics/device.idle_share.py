"""The device's idle share of the traced window, in percent: 1 - the
union of its kernel, memcpy and memset intervals over the window's
length (torch.profiler trace)."""


def read(ctx):
    busy, window = ctx.get("busy_ms"), ctx.get("window_ms")
    if not busy or not window:
        return None
    return 100.0 * (1.0 - busy / window)
