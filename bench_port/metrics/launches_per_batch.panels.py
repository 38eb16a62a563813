"""Launches of the four panel ops' wrappers (validate_decode, qc_stats,
adapter_content, read_hashes: their `.launches` counters) over the traced
requests' padded batches, reads / batch_size rounded up
(launches/batch). Moves panels_reads_per_s."""

OPS = ("validate_decode", "qc_stats", "adapter_content", "read_hashes")


def read(ctx):
    if not ctx.launches:
        return None
    n = sum(ctx.launches.get(op, 0) for op in OPS)
    if not n:
        return None  # the plain versions on the CPU count nothing
    size = int(ctx.cell.params["batch_size"])
    batches = sum(-(-ctx.window.work[i]["reads"] // size)
                  for i in ctx.traced)
    return n / batches
