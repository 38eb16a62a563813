"""Host seconds writing and staging the feed's chunks per GB QC'd, over
the traced requests (s/GB): the program's spans `bs.feed.fill` (the
normalizer, the ragged cut and copy, the tail chunk's copy) and
`bs.feed.stage` (parallel/ingest.py's copy into pinned memory). Moves
qc_gbps."""

from ._spans import span_per


def read(ctx):
    return span_per(ctx, ("bs.feed.fill", "bs.feed.stage"), "bytes", 1e9)
