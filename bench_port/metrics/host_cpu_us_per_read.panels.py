"""Process CPU microseconds, all threads, per read, over the traced run's
untraced requests (cpu_us/read): the host's fastq/parser.py, fastq/batch.py, models/qc.py. Moves panels_reads_per_s."""

from ._lib import host_cpu


def read(ctx):
    return host_cpu(ctx, "reads", 1e6)
