"""Plain FASTQ reading and the QC panels, in torch on any device, in blocks
of records. The reference of every route starts here; it imports nothing
of the port.

Semantics of the panels (FastQC's, as the port's report states them):
Phred = quality byte - offset, 0 below the offset, at most 63; the
per-position panels cover a record's first `width` positions; bases are
A, C, G, T (either case) or other; a read's GC% and mean Phred are over
those positions, rounded half up; lengths clip into the last of 512 bins;
a record is in error when a byte of its sequence or quality has the high
bit set, or a quality byte lies outside [lower, upper].
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass

import numpy as np
import torch

MAX_PHRED = 64
LEN_BINS = 512
GC_BINS = 101
_SCAN = 256 << 20  # bytes a newline scan step


@dataclass
class Records:
    """Line starts and lengths of every record of a FASTQ file (int64 on
    the file's device)."""

    id_start: torch.Tensor
    id_len: torch.Tensor  # without the newline
    seq_start: torch.Tensor
    seq_len: torch.Tensor
    sep_start: torch.Tensor
    qual_start: torch.Tensor
    qual_len: torch.Tensor
    well_formed: torch.Tensor  # '@' id, '+' separator, equal lengths

    def __len__(self) -> int:
        return int(self.seq_len.shape[0])


def to_device(arr: np.ndarray, device) -> torch.Tensor:
    """A uint8 numpy array (a read-only map, say) as a tensor of its own
    on `device`."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # read-only: copied
        t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.to(device) if torch.device(device).type != "cpu" else t.clone()


def records(data: torch.Tensor) -> Records:
    """Every complete four-line record of `data` (uint8). A file that does
    not end in a newline, or whose lines do not come in fours, raises: the
    generators write neither."""
    n = data.numel()
    parts = [torch.nonzero(data[lo:lo + _SCAN] == 10).reshape(-1) + lo
             for lo in range(0, n, _SCAN)]
    nl = torch.cat(parts) if parts else torch.empty(0, dtype=torch.int64)
    if nl.numel() % 4 or (n and int(data[-1]) != 10):
        raise ValueError("not a whole number of four-line records")
    nl = nl.view(-1, 4)
    start = torch.cat([nl.new_zeros(1), nl[:-1, 3] + 1])
    seq_start = nl[:, 0] + 1
    sep_start = nl[:, 1] + 1
    qual_start = nl[:, 2] + 1
    seq_len = nl[:, 1] - seq_start
    qual_len = nl[:, 3] - qual_start
    well = ((data[start] == ord("@")) & (data[sep_start] == ord("+"))
            & (seq_len == qual_len))
    return Records(start, nl[:, 0] - start, seq_start, seq_len, sep_start,
                   qual_start, qual_len, well)


def rows(data: torch.Tensor, start: torch.Tensor, length: torch.Tensor,
         width: int):
    """uint8 [n, w] of each record's first min(length, width) bytes from
    `start`, zero past them (w: the block's longest, at most `width`),
    and the mask of those bytes."""
    w = max(int(length.clamp(max=width).max()) if length.numel() else 0, 1)
    col = torch.arange(w, device=data.device)[None, :]
    mask = col < length.clamp(max=width)[:, None]
    idx = torch.where(mask, start[:, None] + col, 0)
    return torch.where(mask, data[idx], 0), mask


def blocks(n: int, size: int):
    for lo in range(0, n, size):
        yield lo, min(n, lo + size)


class Totals:
    """Running sums of the panels, in `dtype`: int64 is exact; the control
    runs float32 (see control.py)."""

    def __init__(self, dtype=torch.int64):
        self.dtype = dtype
        self.sums = {}

    def add(self, name: str, t: torch.Tensor) -> None:
        t = t.to(self.dtype)
        if name not in self.sums:
            self.sums[name] = t.clone()
            return
        a = self.sums[name]
        if a.shape != t.shape:  # per-position leaves of two block widths
            w = max(a.shape[-1], t.shape[-1])
            a = _widen(a, w)
            t = _widen(t, w)
        self.sums[name] = a + t

    def numpy(self, name: str, width=None) -> np.ndarray:
        a = self.sums[name]
        if width is not None:
            a = _widen(a, width)
        a = a.cpu().numpy()
        return a.astype(np.int64) if self.dtype == torch.int64 else a


def _widen(a: torch.Tensor, w: int) -> torch.Tensor:
    if a.shape[-1] == w:
        return a
    pad = a.new_zeros(a.shape[:-1] + (w - a.shape[-1],))
    return torch.cat([a, pad], -1)


def phred(qual: torch.Tensor, mask: torch.Tensor, offset: int):
    q = qual.to(torch.int64)
    return torch.where(mask & (q >= offset), q - offset, 0).clamp(
        max=MAX_PHRED - 1)


def _bincount(values: torch.Tensor, n_bins: int, dtype) -> torch.Tensor:
    return torch.bincount(values.reshape(-1), minlength=n_bins)[:n_bins].to(
        dtype)


def qc_totals(data: torch.Tensor, recs: Records, *, width: int, offset: int,
              lower: int, upper: int, quality_hist_2d: bool = False,
              dtype=torch.int64, block: int = 1 << 20) -> Totals:
    """The panels' sums over every record, `block` records at a time: each
    block's sums in `dtype`, added into running totals in `dtype`."""
    tot = Totals(dtype)
    for lo, hi in blocks(len(recs), block):
        sl = slice(lo, hi)
        n = hi - lo
        # whole lines: the error tests read past `width` too
        full_s, fmask = rows(data, recs.seq_start[sl], recs.seq_len[sl],
                             1 << 30)
        full_q, qmask = rows(data, recs.qual_start[sl], recs.qual_len[sl],
                             1 << 30)
        qi = full_q.to(torch.int64)
        err = (((full_s >= 0x80) & fmask).any(1)
               | ((full_q >= 0x80) & qmask).any(1)
               | (qmask & ((qi < lower) | (qi > upper))).any(1)
               | ~recs.well_formed[sl])
        del qi, qmask
        seq, mask = full_s[:, :width], fmask[:, :width]
        qual = full_q[:, :width]
        if qual.shape[1] < seq.shape[1]:
            qual = torch.cat([qual, qual.new_zeros(
                (n, seq.shape[1] - qual.shape[1]))], 1)
        qual = qual[:, :seq.shape[1]]
        w = seq.shape[1]
        up = seq & 0xDF
        classes = [mask & (up == ord(b)) for b in "ACGT"]
        count = mask.sum(0, dtype=torch.int64)
        per_pos = torch.stack([c.sum(0, dtype=torch.int64) for c in classes])
        per_pos = torch.cat([per_pos, (count - per_pos.sum(0))[None]])
        ph = phred(qual, mask, offset)
        tot.add("reads", torch.tensor(n, device=data.device))
        tot.add("bases", recs.seq_len[sl].sum())
        tot.add("error_reads", err.sum())
        tot.add("per_pos_base_counts", per_pos.to(dtype))
        tot.add("per_pos_count", count.to(dtype))
        tot.add("per_pos_qual_sum", ph.sum(0).to(dtype))
        tot.add("qual_hist", _bincount(ph[mask], MAX_PHRED, dtype))
        if quality_hist_2d:
            pos = torch.arange(w, device=data.device)[None, :]
            tot.add("per_pos_qual_hist", _bincount(
                (ph * w + pos)[mask], MAX_PHRED * w, dtype).view(MAX_PHRED, w))
        cnt = mask.sum(1)
        gc = (classes[1] | classes[2]).sum(1)
        qs = ph.sum(1)
        some = cnt > 0
        safe = cnt.clamp(min=1)
        gc_bin = (200 * gc + cnt) // (2 * safe)
        mq_bin = ((2 * qs + cnt) // (2 * safe)).clamp(max=MAX_PHRED - 1)
        tot.add("length_hist", _bincount(
            recs.seq_len[sl].clamp(max=LEN_BINS - 1), LEN_BINS, dtype))
        tot.add("gc_hist", _bincount(gc_bin[some], GC_BINS, dtype))
        tot.add("mean_qual_hist", _bincount(mq_bin[some], MAX_PHRED, dtype))
    return tot


def core_report(tot: Totals, width: int) -> dict:
    """The report's core leaves from the totals, as the port's QCReport
    names them."""
    g = tot.numpy
    bases = g("bases")
    pp = g("per_pos_base_counts", width)
    qual_hist = g("qual_hist")
    cnt = g("per_pos_count", width)
    gc = pp[1].sum() + pp[2].sum()
    return dict(
        reads=g("reads"), bases=bases, error_reads=g("error_reads"),
        gc_fraction=float(gc) / max(float(bases), 1.0),
        mean_quality=float(np.sum(qual_hist * np.arange(MAX_PHRED)))
        / max(float(bases), 1.0),
        base_counts=pp.sum(1),
        per_position_mean_quality=g("per_pos_qual_sum", width)
        / np.maximum(cnt, 1),
        qual_hist=qual_hist, length_hist=g("length_hist"),
        gc_hist=g("gc_hist"), mean_qual_hist=g("mean_qual_hist"),
        per_pos_base_counts=pp, per_pos_count=cnt)


def leaves_equal(got, want) -> bool:
    """Whether a report leaf equals the reference's exactly; arrays of two
    widths are compared with the narrower one's missing columns as 0."""
    if want is None or got is None:
        return got is None and want is None
    if isinstance(want, (float, np.floating)):
        return float(got) == float(want)
    a, b = np.asarray(got), np.asarray(want)
    if a.ndim != b.ndim:
        return False
    if a.shape != b.shape:
        if a.shape[:-1] != b.shape[:-1]:
            return False
        w = max(a.shape[-1], b.shape[-1])
        a = np.concatenate([a, np.zeros(a.shape[:-1] + (w - a.shape[-1],),
                                        a.dtype)], -1)
        b = np.concatenate([b, np.zeros(b.shape[:-1] + (w - b.shape[-1],),
                                        b.dtype)], -1)
    return bool(np.array_equal(a, b))
