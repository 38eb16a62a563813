"""Reads taken through QCModel.run_file with the panels, over the window
(reads/s)."""


def read(ctx):
    return ctx.window.total("reads") / ctx.window.seconds
