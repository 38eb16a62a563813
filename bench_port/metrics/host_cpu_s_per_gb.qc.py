"""Process CPU seconds, all threads, per GB QC'd, over the traced run's
untraced requests (cpu_s/GB): the host feed of models/qc.py,
parallel/ingest.py and native/. Moves qc_gbps."""

from ._lib import host_cpu


def read(ctx):
    return host_cpu(ctx, "bytes", 1e9)
