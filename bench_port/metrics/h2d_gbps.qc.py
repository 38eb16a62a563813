"""HtoD copy bytes over those copies' device time in the traced stretch
(GB/s): the copy stream of parallel/ingest.py. Moves qc_gbps."""

from ._lib import h2d_gbps


def read(ctx):
    return h2d_gbps(ctx)
