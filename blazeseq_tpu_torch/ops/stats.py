"""QC statistics over padded read batches (counterpart of
blazeseq_tpu/ops/stats.py).

Device leaves are int32, as in the reference: single-batch magnitudes are
small, and cross-batch totals are accumulated on the host in int64 by
`QCAccumulator`. Every leaf is additive, so batches and chunks merge by
addition. `qc_stats` is plain torch ops; it was jnp outside any Pallas kernel
in the reference.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .common import length_mask

MAX_PHRED = 64  # histogram bins [0, 64)
LEN_BINS = 512  # read-length distribution bins; longer reads clip to 511
GC_BINS = 101  # per-read GC% bins 0..100

_BASES = b"ACGT"  # base classes: A C G T other


class QCStats(NamedTuple):
    """Additive per-batch QC statistics. Leaves are int32 tensors on the
    device, or int64 numpy arrays once accumulated on the host."""

    reads: torch.Tensor  # []
    bases: torch.Tensor  # []
    base_counts: torch.Tensor  # [5]  A C G T other
    per_pos_base_counts: torch.Tensor  # [5, L]
    per_pos_qual_sum: torch.Tensor  # [L]
    per_pos_count: torch.Tensor  # [L]
    qual_hist: torch.Tensor  # [MAX_PHRED]
    gc_count: torch.Tensor  # []  total G+C bases
    error_reads: torch.Tensor  # [] reads with validation errors
    length_hist: torch.Tensor  # [LEN_BINS] reads by true length (clipped)
    gc_hist: torch.Tensor  # [GC_BINS] reads by GC% of in-window bases
    mean_qual_hist: torch.Tensor  # [MAX_PHRED] reads by rounded mean Phred
    # full per-position quality distribution [MAX_PHRED, L]; None when not
    # tracked
    per_pos_qual_hist: Optional[torch.Tensor] = None

    def merge(self, other: "QCStats") -> "QCStats":
        """Leaf-wise sum of two batches' stats of one width."""
        return QCStats(*(None if a is None else a + b
                         for a, b in zip(self, other)))

    def to_numpy(self) -> "QCStats":
        """The leaves as int64 numpy arrays, brought to the host in one
        device-to-host copy (None stays None)."""
        flat = torch.cat([torch.as_tensor(a).reshape(-1).to(torch.int64)
                          for a in self if a is not None]).cpu().numpy()
        out, pos = [], 0
        for a in self:
            if a is None:
                out.append(None)
                continue
            k = int(np.prod(a.shape))
            out.append(flat[pos:pos + k].reshape(tuple(a.shape)))
            pos += k
        return QCStats(*out)


def qcstats_from_numpy(leaves) -> QCStats:
    """A port `QCStats` of int32 CPU tensors from the reference package's
    `QCStats` (or any sequence of its leaves) given as numpy arrays."""
    return QCStats(*(None if a is None else torch.from_numpy(
        np.array(a, dtype=np.int32)) for a in leaves))


def zero_stats(max_len: int, qual_hist_2d: bool = False) -> QCStats:
    def z(*s):
        return torch.zeros(s, dtype=torch.int32)

    return QCStats(z(), z(), z(5), z(5, max_len), z(max_len), z(max_len),
                   z(MAX_PHRED), z(), z(), z(LEN_BINS), z(GC_BINS),
                   z(MAX_PHRED),
                   per_pos_qual_hist=(z(MAX_PHRED, max_len)
                                      if qual_hist_2d else None))


def _row_valid(n: int, n_records, device) -> torch.Tensor:
    """bool[n]: row < n_records, a host integer (compared without a
    host-to-device copy); None means every row."""
    return torch.arange(n, device=device) < (n if n_records is None
                                             else n_records)


def _masked_phred(qual, mask, offset: int) -> torch.Tensor:
    """clip(qual - offset, 0, MAX_PHRED - 1) on masked positions, 0 off the
    mask, as int32."""
    q = qual.to(torch.int32)
    ph = torch.where(mask & (q >= offset), q - offset, 0)
    return torch.clamp(ph, max=MAX_PHRED - 1)


def _row_partials_impl(mask, phred, seq):
    """Per-read (gc_bases, phred_sum, in_window_count), each int32[n], from
    the mask and the masked phred scores."""
    upper = seq & 0xDF
    isgc = mask & ((upper == ord("C")) | (upper == ord("G")))
    gc = isgc.sum(1, dtype=torch.int32)
    qsum = torch.where(mask, phred, 0).sum(1, dtype=torch.int32)
    cnt = mask.sum(1, dtype=torch.int32)
    return gc, qsum, cnt


def row_partials(seq, qual, lengths, offset: int, n_records=None,
                 col_offset=0):
    """Per-read (gc, phred_sum, in_window_count) partials for this column
    slice (see qc_stats for the masking semantics)."""
    n, L = seq.shape
    row_valid = _row_valid(n, n_records, seq.device)
    mask = length_mask(lengths, L, col_offset) & row_valid[:, None]
    return _row_partials_impl(mask, _masked_phred(qual, mask, int(offset)),
                              seq)


def bin_counts(values: torch.Tensor, valid: Optional[torch.Tensor],
               n_bins: int) -> torch.Tensor:
    """int32[n_bins] counts of `values` over the `valid` entries (all when
    None); values lie in [0, n_bins) wherever valid."""
    idx = values.to(torch.int64)
    if valid is not None:
        idx = torch.where(valid, idx, n_bins)
    idx = idx.reshape(-1)
    out = torch.zeros(n_bins + 1, dtype=torch.int64, device=values.device)
    out.scatter_add_(0, idx, torch.ones_like(idx))
    return out[:n_bins].to(torch.int32)


def row_histograms(gc, qsum, cnt, lengths, n_records):
    """Bin per-read partials into (length_hist, gc_hist, mean_qual_hist).
    Lengths are the TRUE lengths (may exceed the padded width; clipped into
    the last bin); GC% and mean quality are over the in-window bases `cnt`."""
    row_valid = _row_valid(gc.shape[0], n_records, gc.device)
    lens = torch.clamp(lengths.to(torch.int32), max=LEN_BINS - 1)
    nonempty = row_valid & (cnt > 0)
    safe = torch.clamp(cnt, min=1)
    # round-half-up integer percent / mean: floor((100*gc + cnt/2) / cnt)
    gc_bin = torch.div(200 * gc + cnt, 2 * safe, rounding_mode="floor")
    mq_bin = torch.clamp(
        torch.div(2 * qsum + cnt, 2 * safe, rounding_mode="floor"),
        max=MAX_PHRED - 1)
    return (bin_counts(lens, row_valid, LEN_BINS),
            bin_counts(gc_bin, nonempty, GC_BINS),
            bin_counts(mq_bin, nonempty, MAX_PHRED))


def qc_stats(seq, qual, lengths, offset: int, n_records=None,
             error_codes=None, col_offset=0,
             count_scalars: bool = True, row_stats: bool = True,
             qual_hist_2d: bool = False) -> QCStats:
    """QCStats for one padded batch seq, qual u8[n, L], lengths int32[n].

    `n_records` separates genuine records from padding rows. `col_offset`
    is the batch's starting column when it holds a column slice of longer
    records; `count_scalars=False` zeroes the per-record scalars and
    per-read panels (reads, bases, error_reads, the three row histograms),
    for every column slice but the first."""
    n, L = seq.shape
    dev = seq.device
    offset = int(offset)
    row_valid = _row_valid(n, n_records, dev)
    mask = length_mask(lengths, L, col_offset) & row_valid[:, None]
    phred = _masked_phred(qual, mask, offset)

    upper = seq & 0xDF
    per_pos_rows = [(mask & (upper == b)).sum(0, dtype=torch.int32)
                    for b in _BASES]
    per_pos_count = mask.sum(0, dtype=torch.int32)
    per_pos_rows.append(per_pos_count - sum(per_pos_rows))  # "other"
    per_pos_base = torch.stack(per_pos_rows)  # [5, L]
    base_counts = per_pos_base.sum(1, dtype=torch.int32)

    if qual_hist_2d:
        # [MAX_PHRED, L]: excluded positions go to the dropped row MAX_PHRED
        idx = torch.where(mask, phred, MAX_PHRED).to(torch.int64)
        pp = torch.zeros(MAX_PHRED + 1, L, dtype=torch.int64, device=dev)
        pp.scatter_add_(0, idx, torch.ones_like(idx))
        pp_qual_hist = pp[:MAX_PHRED].to(torch.int32)
        qual_hist = pp_qual_hist.sum(1, dtype=torch.int32)
    else:
        pp_qual_hist = None
        qual_hist = bin_counts(phred, mask, MAX_PHRED)
    per_pos_qual_sum = phred.sum(0, dtype=torch.int32)

    zero = torch.zeros((), dtype=torch.int32, device=dev)
    gc = base_counts[1] + base_counts[2]
    err = (((error_codes != 0) & row_valid).sum(dtype=torch.int32)
           if error_codes is not None else zero)
    scale = 1 if count_scalars else 0
    if row_stats:
        gcr, qsr, cntr = _row_partials_impl(mask, phred, seq)
        len_h, gc_h, mq_h = row_histograms(gcr, qsr, cntr, lengths, n_records)
        len_h, gc_h, mq_h = len_h * scale, gc_h * scale, mq_h * scale
    else:
        # per-read panels need full rows; a column-sliced caller bins the
        # summed row_partials itself
        len_h = torch.zeros(LEN_BINS, dtype=torch.int32, device=dev)
        gc_h = torch.zeros(GC_BINS, dtype=torch.int32, device=dev)
        mq_h = torch.zeros(MAX_PHRED, dtype=torch.int32, device=dev)
    reads = torch.full((), n if n_records is None else int(n_records),
                       dtype=torch.int32, device=dev)
    bases = torch.where(row_valid, lengths.to(torch.int32), 0).sum(
        dtype=torch.int32)
    return QCStats(
        reads=reads * scale,
        bases=bases * scale,
        base_counts=base_counts,
        per_pos_base_counts=per_pos_base,
        per_pos_qual_sum=per_pos_qual_sum,
        per_pos_count=per_pos_count,
        qual_hist=qual_hist,
        gc_count=gc,
        error_reads=err * scale,
        length_hist=len_h,
        gc_hist=gc_h,
        mean_qual_hist=mq_h,
        per_pos_qual_hist=pp_qual_hist,
    )


class QCAccumulator:
    """Host-side int64 accumulator for streaming QC over many batches."""

    def __init__(self):
        self._tot = None

    def add(self, stats: QCStats) -> None:
        host = stats.to_numpy()
        if self._tot is None:
            self._tot = host
        else:
            self._tot = QCStats(*(None if a is None else _add_padded(a, b)
                                  for a, b in zip(self._tot, host)))

    @property
    def total(self) -> QCStats:
        return self._tot

    # -- derived metrics -----------------------------------------------------
    def gc_fraction(self) -> float:
        t = self._tot
        return float(t.gc_count) / max(float(t.bases), 1.0)

    def mean_quality(self) -> float:
        t = self._tot
        total = float(np.sum(t.qual_hist * np.arange(MAX_PHRED)))
        return total / max(float(t.bases), 1.0)

    def per_position_mean_quality(self) -> np.ndarray:
        t = self._tot
        cnt = np.maximum(t.per_pos_count, 1)
        return t.per_pos_qual_sum / cnt

    def mean_read_length(self) -> float:
        t = self._tot
        return float(t.bases) / max(float(t.reads), 1.0)

    def modal_read_length(self) -> int:
        """Most common read length (lengths >= LEN_BINS clip to the last
        bin)."""
        return int(np.argmax(self._tot.length_hist))

    def per_position_quality_quartiles(
            self, probs=(0.10, 0.25, 0.50, 0.75, 0.90)) -> np.ndarray:
        """[len(probs), L] lower empirical percentiles per position from the
        tracked distribution (FastQC per-base boxplot: deciles, quartiles
        and median). Needs qual_hist_2d tracking
        (QCModel(track_quartiles=True)); positions with no in-window bases
        report 0."""
        t = self._tot
        if t.per_pos_qual_hist is None:
            raise ValueError(
                "per-position quality distribution was not tracked; "
                "construct QCModel(track_quartiles=True) or call "
                "qc_stats(qual_hist_2d=True)")
        cum = np.cumsum(t.per_pos_qual_hist, axis=0)  # [MAX_PHRED, L]
        n = cum[-1]
        rows = []
        for p in probs:
            # inverse empirical CDF: smallest phred v with cdf(v) >= p
            thresh = np.maximum(np.ceil(p * n).astype(np.int64), 1)
            v = (cum < thresh[None, :]).sum(axis=0)
            rows.append(np.where(n > 0, v, 0))
        return np.stack(rows)


def _add_padded(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Sum arrays whose trailing (position) axis may differ across batches."""
    if a.shape == b.shape:
        return a + b
    L = max(a.shape[-1], b.shape[-1])

    def widen(x):
        pad = [(0, 0)] * (x.ndim - 1) + [(0, L - x.shape[-1])]
        return np.pad(x, pad)

    return widen(a) + widen(b)
