"""One sample of a NovaSeq 6000 2 x 150 run (read 1), made on the device.

Ids follow Illumina's bcl2fastq / BCL Convert layout
`@<instrument>:<run>:<flowcell>:<lane>:<tile>:<x>:<y> 1:N:0:<i7>+<i5>`:
tiles on the S4 surface-swath-tile scheme in file order, x and y of four or
five digits (so the ids vary in width), a dual 8 + 8 index with a share of
one-base mismatches. Reads are 150 bp: a fragment of `gc` G+C content whose
insert is shorter than the read for a share of them (the adapter read
through, then the index and P7, then poly-G, the two-colour chemistry's "no
signal"), adapter dimers, poly-G tails, a share of reads that copy an
earlier read's sequence, and N calls. Quality is binned to RTA3's four
values from a decay over the read, and a share of reads end in Phred 2
(RTA's mark of a read's failing end). Every draw is a hash of the seed, the
read and the position, so a seed gives the same shapes with other bytes.
"""

from __future__ import annotations

import torch

from ._common import const, digits, draws, flat_rows, join, stream_key, \
    uniform, write_blocks

_BLOCK = 1 << 19  # reads a device block
_CHAIN = 24  # copies followed back to their first read (0.2**24 left)


def _insert_lengths(t, keys, c):
    """Each template's insert length: 0 for an adapter dimer, short for a
    short insert, the read length otherwise."""
    L = c["read_length"]
    u = uniform(draws(keys["insert"], t))
    lo, hi = c["short_insert_range"]
    short = lo + draws(keys["insert_len"], t) % (hi - lo + 1)
    dimer = c["adapter_dimer_fraction"]
    return torch.where(u < dimer, 0, torch.where(
        u < dimer + c["short_insert_fraction"], short, L))


def _roots(i, keys, c):
    """The read whose sequence each read carries: itself, or for a copy the
    first read of its chain of copies."""
    frac, far = c["duplicate_fraction"], c["duplicate_distance"]
    r = i
    for _ in range(_CHAIN):
        copy = (uniform(draws(keys["dup"], r)) < frac) & (r > 0)
        # a read among the `far` before it, uniformly
        back = 1 + draws(keys["dup_src"], r) % r.clamp(min=1, max=far)
        r = torch.where(copy, r - back, r)
    return r


def _sequence(t, keys, c, device):
    """uint8 [n, L] bases of templates t, and planted counts."""
    L = c["read_length"]
    pos = torch.arange(L, dtype=torch.int64, device=device)
    d = draws(keys["base"], t, pos) % 1000
    gc = int(round(c["gc"] * 1000))
    seq = torch.where(d < gc // 2, ord("C"), torch.where(
        d < gc, ord("G"), torch.where(d < gc + (1000 - gc) // 2, ord("A"),
                                      ord("T")))).to(torch.uint8)
    tail = bytes(c["adapter_read_through"], "ascii") + bytes(
        c["index"][0], "ascii") + bytes(c["p7"], "ascii")
    tail_t = torch.frombuffer(bytearray(tail + b"G" * L),
                              dtype=torch.uint8).to(device)
    ins = _insert_lengths(t, keys, c)
    past = pos[None, :] - ins[:, None]
    seq = torch.where(past >= 0, tail_t[past.clamp(min=0)], seq)
    pg = uniform(draws(keys["polyg"], t)) < c["polyg_fraction"]
    lo, hi = c["polyg_tail_range"]
    tl = lo + draws(keys["polyg_len"], t) % (hi - lo + 1)
    seq = torch.where(pg[:, None] & (pos[None, :] >= L - tl[:, None]),
                      ord("G"), seq).to(torch.uint8)
    return seq, ins, pg


def _quality(i, keys, c, device):
    """Phred of reads i, binned: the decay, an exponential jitter below it,
    then RTA3's bins."""
    L = c["read_length"]
    q = c["quality_model"]
    pos = torch.arange(L, dtype=torch.int64, device=device)
    u = uniform(draws(keys["qual"], i, pos))
    raw = (q["start"] - q["slope"] * pos[None, :] / (L - 1)
           + q["jitter_scale"] * torch.log1p(-u))
    bins = torch.tensor(c["quality_bins"], dtype=torch.int64, device=device)
    edges = torch.tensor(c["bin_edges"], dtype=torch.float64, device=device)
    phred = bins[torch.bucketize(raw, edges, right=True)]
    # a failing end marked Phred 2
    tail = uniform(draws(keys["q2"], i)) < c["q2_tail_fraction"]
    lo, hi = c["q2_tail_range"]
    tl = lo + draws(keys["q2_len"], i) % (hi - lo + 1)
    marked = tail[:, None] & (pos[None, :] >= L - tl[:, None])
    return torch.where(marked, min(c["quality_bins"]), phred), tail


def _header(i, keys, c, n_total, device):
    """uint8 rows of the ids (with '@' and the newline) and their widths."""
    h = c["header"]
    n = i.shape[0]
    tiles = torch.tensor(
        [s * 1000 + w * 100 + k for s in range(1, h["surfaces"] + 1)
         for w in range(1, h["swaths"] + 1)
         for k in range(1, h["tiles_per_swath"] + 1)], dtype=torch.int64,
        device=device)
    tile = tiles[i * tiles.numel() // n_total]
    (x0, x1), (y0, y1) = h["x_range"], h["y_range"]
    x = x0 + draws(keys["x"], i) % (x1 - x0 + 1)
    y = y0 + draws(keys["y"], i) % (y1 - y0 + 1)
    i7 = torch.frombuffer(bytearray(c["index"][0], "ascii"),
                          dtype=torch.uint8).to(device)[None, :].repeat(n, 1)
    miss = uniform(draws(keys["index_miss"], i)) < h["index_mismatch_fraction"]
    col = draws(keys["index_col"], i) % i7.shape[1]
    sub = torch.frombuffer(bytearray(b"ACGT"), dtype=torch.uint8).to(device)[
        draws(keys["index_base"], i) % 4]
    rows = torch.arange(n, device=device)
    i7[rows[miss], col[miss]] = sub[miss]
    prefix = "@%s:%d:%s:%d:" % (h["instrument"], h["run"], h["flowcell"],
                                h["lane"])
    return join([
        const(prefix.encode(), n, device), digits(tile, 4, pad=True),
        const(b":", n, device), digits(x, 5, pad=False),
        const(b":", n, device), digits(y, 5, pad=False),
        const(b" 1:N:0:", n, device), (i7, torch.full_like(i, i7.shape[1])),
        const(b"+" + c["index"][1].encode() + b"\n", n, device)])


def generate(config: dict, seed: int, device, reads=None):
    c = config
    n_total = int(c["reads"] if reads is None else reads)
    L = int(c["read_length"])
    names = ("insert", "insert_len", "dup", "dup_src", "base", "polyg",
             "polyg_len", "qual", "x", "y", "index_miss", "index_col",
             "index_base", "ncall", "q2", "q2_len")
    keys = {k: stream_key(seed, s) for s, k in enumerate(names)}
    offset = int(c["quality_offset"])
    pos = torch.arange(L, dtype=torch.int64, device=device)

    def sizes(lo, hi):
        i = torch.arange(lo, hi, dtype=torch.int64, device=device)
        return _header(i, keys, c, n_total, device)[1] + 2 * L + 4

    def make(lo, hi):
        i = torch.arange(lo, hi, dtype=torch.int64, device=device)
        t = _roots(i, keys, c)
        seq, ins, pg = _sequence(t, keys, c, device)
        phred, q2_tail = _quality(i, keys, c, device)
        ncall = uniform(draws(keys["ncall"], i, pos)) < c["n_call_fraction"]
        seq = torch.where(ncall, ord("N"), seq).to(torch.uint8)
        qual = (torch.where(ncall, min(c["quality_bins"]), phred)
                + offset).to(torch.uint8)
        ids, idw = _header(i, keys, c, n_total, device)
        rows, widths = join([
            (ids, idw), (seq, torch.full_like(i, L)),
            const(b"\n+\n", hi - lo, device), (qual, torch.full_like(i, L)),
            const(b"\n", hi - lo, device)])
        planted = dict(reads=hi - lo, bases=(hi - lo) * L,
                       copies=int((t != i).sum()),
                       n_calls=int(ncall.sum()),
                       dimers=int((ins == 0).sum()),
                       short_inserts=int(((ins > 0) & (ins < L)).sum()),
                       adapter_in_read=int(
                           (ins + len(c["adapter_read_through"][:12])
                            <= L).sum()),
                       polyg_tails=int(pg.sum()),
                       q2_tails=int(q2_tail.sum()))
        return flat_rows(rows, widths), planted

    return write_blocks("novaseq6000_150bp_binned", n_total, _BLOCK, sizes,
                        make)
