"""Kernel B (csrc/uniform_qc.cu via ops/uniform_qc.py): its least time
over its summed device time in the traced stretch (%). Moves qc_gbps.

The least kernel B work of a request is the file read once: the smaller
of the file's bytes and the bytes uploaded to the kernel (a semi-tier
chunk pads its ids, so it uploads more than the file holds), and each
launch's sums written once; the operations as the frozen arithmetic
counts them. Launches that the request's result does not keep (a failed
uniform try before the semi tier, a histogram re-run) count in the time
and not in the bound. When a chunk of a traced request took the ragged or
the host tier, kernel B did not read the whole file and the reader
returns nothing."""

import numpy as np

from ..roofline import bounds
from ._lib import bound, lengths, share_pct, traced


def read(ctx):
    t = traced(ctx)
    launches = ctx.launches.get("uniform_qc", 0)
    if t is None or not launches:
        return None
    for i in ctx.traced:
        tiers = ctx.window.info[i]["tier_chunks"]
        if tiers.get("ragged", 0) or tiers.get("host", 0):
            return None
    file_bytes = ctx.traced_work("bytes")
    records = ctx.traced_work("reads")
    n_bytes = min(file_bytes, t.h2d_bytes) if t.h2d_bytes else file_bytes
    width = int(ctx.cell.params["max_read_len"])
    cnt = int(min(np.max(lengths(ctx)), width))
    b, ops = bounds.kernel_b(n_bytes, records, cnt, n_bytes / records,
                             launches)
    return share_pct(ctx, bound(ctx, b, ops), t.kernel_seconds("uniform_qc"))
