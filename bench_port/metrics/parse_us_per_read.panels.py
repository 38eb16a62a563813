"""Host microseconds of the parser per read, over the traced requests
(us/read): the program's span `bs.parse.batch` (fastq/parser.py's
next_padded: scan, validate and gather into padded rows, its buffers
included). Moves panels_reads_per_s."""

from ._spans import span_per


def read(ctx):
    return span_per(ctx, ("bs.parse.batch",), "reads", 1e6)
