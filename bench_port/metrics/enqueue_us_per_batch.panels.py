"""Host microseconds a padded batch spends calling the panel ops, over
the traced requests (us/batch): the program's spans `bs.qc.step`
(validate and qc_stats), `bs.qc.adapters` and `bs.qc.hashes`, per batch
of its counter `parse.batches`. Moves panels_reads_per_s."""

from ._spans import counted, requests, seconds

OPS = ("bs.qc.step", "bs.qc.adapters", "bs.qc.hashes")


def read(ctx):
    reqs = requests(ctx)
    if reqs is None:
        return None
    batches = counted(reqs, "parse.batches")
    if not batches:
        return None
    return seconds(reqs, *OPS) / batches * 1e6
