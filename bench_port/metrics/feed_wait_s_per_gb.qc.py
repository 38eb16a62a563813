"""Host seconds blocked on the card in the feed per GB QC'd, over the
traced requests (s/GB): the program's span `bs.feed.wait` (a pinned
buffer's last upload, the oldest chunk's step, in parallel/ingest.py).
Moves qc_gbps."""

from ._spans import span_per


def read(ctx):
    return span_per(ctx, ("bs.feed.wait",), "bytes", 1e9)
