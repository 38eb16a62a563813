"""The four panel kernels of QCModel.run_file (csrc/validate.cu,
qc_stats.cu, adapter.cu, dedup.cu): their summed least times over their
summed device times in the traced stretch (%). Moves panels_reads_per_s.

Each request parses the file into batches of `batch_size` records padded
to batch_size x max_read_len; every batch runs validate, qc_stats (with
the quartile leaf) and the adapter scan, and the batches of the first
`dup_track_limit` reads run read_hashes on those reads."""

import numpy as np

from ..roofline import bounds
from ._lib import adapter_scan_work, batches, bound, lengths, share_pct, \
    traced

KERNELS = ("validate_decode_kernel", "qc_stats_kernel", "adapter_kernel",
           "read_hashes_kernel")


def request_bound_s(ctx) -> float:
    """The four kernels' least time over one request."""
    p = ctx.cell.params
    n_rows, L = int(p["batch_size"]), int(p["max_read_len"])
    limit = int(p["dup_track_limit"])
    ads = [a.encode("ascii") for a in p["adapters"]]
    lens = lengths(ctx)
    upto, starts = adapter_scan_work(ctx, ads, L)
    total = 0.0
    for lo, hi in batches(len(lens), n_rows):
        b = np.zeros(n_rows, np.int64)
        b[:hi - lo] = lens[lo:hi]
        n_valid = hi - lo
        total += bound(ctx, *bounds.validate(b, L))
        total += bound(ctx, *bounds.qc_stats(b, L, n_valid, True))
        total += bound(ctx, *bounds.adapters(upto[lo:hi],
                                              int(starts[lo:hi].sum()),
                                              n_valid, len(ads), L))
        if lo < limit:
            take = min(hi, limit) - lo
            total += bound(ctx, *bounds.hashes(b, L, n_rows, take))
    return total


def read(ctx):
    t = traced(ctx)
    if t is None:
        return None
    kernel_s = t.kernel_seconds(*KERNELS)
    if kernel_s <= 0:
        return None
    return share_pct(ctx, len(ctx.traced) * request_bound_s(ctx), kernel_s)
