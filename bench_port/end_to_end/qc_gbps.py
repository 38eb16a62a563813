"""File bytes QC'd over the window (GB/s, 10^9 bytes)."""


def read(ctx):
    return ctx.window.total("bytes") / ctx.window.seconds / 1e9
