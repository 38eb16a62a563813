"""Input reads taken through the CLI command, over the window (reads/s)."""


def read(ctx):
    return ctx.window.total("reads") / ctx.window.seconds
