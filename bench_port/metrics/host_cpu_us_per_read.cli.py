"""Process CPU microseconds, all threads, per read, over the traced run's
untraced requests (cpu_us/read): the host's __main__.py, the parser and the serialiser. Moves cli_reads_per_s."""

from ._lib import host_cpu


def read(ctx):
    return host_cpu(ctx, "reads", 1e6)
