"""The trim kernel (csrc/trim.cu via ops/trim.py): its least time over its
summed device time in the traced stretch (%). Moves cli_reads_per_s.

The trim command takes the file in batches of 4,096 records, each padded
to its longest read rounded up to 128 columns; one call a batch."""

import numpy as np

from ..roofline import bounds
from ._lib import batches, bound, lengths, share_pct, traced

BATCH = 4096
WIDTH_UNIT = 128


def read(ctx):
    t = traced(ctx)
    if t is None:
        return None
    kernel_s = t.kernel_seconds("trim")
    if kernel_s <= 0:
        return None
    lens = lengths(ctx)
    total = 0.0
    for lo, hi in batches(len(lens), BATCH):
        b = lens[lo:hi]
        L = int(-(-max(int(b.max()), 1) // WIDTH_UNIT) * WIDTH_UNIT)
        total += bound(ctx, *bounds.trim(np.asarray(b), L))
    return share_pct(ctx, len(ctx.traced) * total, kernel_s)
