"""Host microseconds of the padded batches' uploads per read, over the
traced requests (us/read): the program's span `bs.qc.upload` (the three
pageable copies of QCModel._upload). Moves panels_reads_per_s."""

from ._spans import span_per


def read(ctx):
    return span_per(ctx, ("bs.qc.upload",), "reads", 1e6)
