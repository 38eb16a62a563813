"""QC statistics over padded read batches (counterpart of
blazeseq_tpu/ops/stats.py).

Device leaves are int32, as in the reference: single-batch magnitudes are
small, and cross-batch totals are accumulated on the host in int64 by
`QCAccumulator`. Every leaf is additive, so batches and chunks merge by
addition. The reference's `qc_stats` is jnp outside any Pallas kernel; here
`qc_stats_torch` is its plain torch version, and `qc_stats` dispatches on
the tensors' device: CPU tensors take the plain version, CUDA tensors the
hand-written kernel in csrc/qc_stats.cu, or the call raises. The
dispatcher's leaves are views of one int32 buffer (`_layout`), and
`qc_stats(..., out=total)` adds a batch into such a buffer in place: a
running total over many batches with no zero fill or merge per batch.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import _kernels
from .common import check_cuda_batch, length_mask

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
        base = _flat_buffer(self)
        if base is not None:  # the leaves are views of one buffer
            flat = base.cpu().numpy().astype(np.int64)
        else:
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


def qc_stats_torch(seq, qual, lengths, offset: int, n_records=None,
                   error_codes=None, col_offset=0,
                   count_scalars: bool = True, row_stats: bool = True,
                   qual_hist_2d: bool = False) -> QCStats:
    """Plain torch version of `qc_stats`."""
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


@functools.cache
def _layout(L: int, qual_hist_2d: bool):
    """(shape, size) of each QCStats leaf of an [n, L] batch in field order,
    (None, 0) for an untracked leaf: the layout of the kernel's one output
    buffer (csrc/qc_stats.cu, Layout)."""
    shapes = ((), (), (5,), (5, L), (L,), (L,), (MAX_PHRED,), (), (),
              (LEN_BINS,), (GC_BINS,), (MAX_PHRED,),
              (MAX_PHRED, L) if qual_hist_2d else None)
    return tuple((s, 0 if s is None else math.prod(s)) for s in shapes)


def _views(flat, layout) -> QCStats:
    """The leaves as views of `flat`, in the layout's order."""
    parts = flat.split([k for _, k in layout])
    return QCStats(*(None if shape is None else
                     part if len(shape) == 1 else part.view(shape)
                     for (shape, _), part in zip(layout, parts)))


def _flat_buffer(st):
    """The int32 buffer whose views in `_layout` order are st's leaves, or
    None when they are not."""
    if not all(a is None or isinstance(a, torch.Tensor) for a in st):
        return None
    base = st.reads._base
    pc = st.per_pos_count
    if base is None or base.dtype != torch.int32 or base.dim() != 1 \
            or pc.dim() != 1:
        return None
    layout = _layout(pc.shape[0], st.per_pos_qual_hist is not None)
    if base.numel() != sum(k for _, k in layout):
        return None
    pos = base.storage_offset()
    for leaf, (shape, k) in zip(st, layout):
        if shape is None:
            continue
        if leaf._base is not base or tuple(leaf.shape) != shape \
                or leaf.storage_offset() != pos or not leaf.is_contiguous():
            return None
        pos += k
    return base


# the last running total that passed `_total_buffer`: (out, (L,
# qual_hist_2d, device), its buffer); a batch loop passes the same one
# every call
_checked_total = [None, None, None]


def _total_buffer(out, L: int, qual_hist_2d: bool, device):
    """The buffer of a running total `out` for an [n, L] batch on `device`,
    or ValueError unless out's leaves are views of one int32 buffer there
    in the layout of (L, qual_hist_2d), as qc_stats returns them."""
    seen = _checked_total
    key = (L, qual_hist_2d, device)
    if out is seen[0] and key == seen[1]:
        return seen[2]
    if not isinstance(out, QCStats):
        raise ValueError("qc_stats: out must be a QCStats, got %s"
                         % type(out).__name__)
    if (out.per_pos_qual_hist is not None) != qual_hist_2d:
        raise ValueError("qc_stats: out %s the [64, L] leaf and "
                         "qual_hist_2d=%s" % (
                             "has" if qual_hist_2d is False else "lacks",
                             qual_hist_2d))
    width = getattr(out.per_pos_count, "shape", (None,))[-1]
    if width != L:
        raise ValueError("qc_stats: out is %s columns wide, the batch %d"
                         % (width, L))
    base = _flat_buffer(out)
    if base is None:
        raise ValueError("qc_stats: out's leaves must be views of one int32 "
                         "buffer, as qc_stats returns them")
    if base.device != device:
        raise ValueError("qc_stats: out is on %s, the batch on %s"
                         % (base.device, device))
    seen[:] = [out, key, base]
    return base


@functools.cache
def _group(L: int) -> int:
    """The lanes the kernel gives a row: one a 16-byte piece, a power of
    two, at most a warp."""
    pieces = max(1, -(-L // 16))
    return min(32, 1 << (pieces - 1).bit_length())


def _qc_stats_cuda(seq, qual, lengths, offset, n_records, error_codes,
                   col_offset, count_scalars, row_stats, qual_hist_2d, out,
                   rows_per_block=0, cluster=0):
    """The kernel's launch. rows_per_block and cluster (0: the kernel's
    own choice) are for a sweep of its grid."""
    check_cuda_batch("qc_stats", [("seq", seq), ("qual", qual)],
                     [("lengths", lengths), ("error_codes", error_codes)])
    n, L = seq.shape
    dev = seq.device
    qual_hist_2d = bool(qual_hist_2d)
    layout = _layout(L, qual_hist_2d)
    if out is None:
        # every leaf a view of one buffer: one zero fill, one launch
        flat = torch.zeros(sum(k for _, k in layout), dtype=torch.int32,
                           device=dev)
        leaves = _views(flat, layout)
    else:
        flat = _total_buffer(out, L, qual_hist_2d, dev)
        leaves = out
    n_rec = n if n_records is None else int(n_records)
    reads = n_rec if count_scalars else 0
    if n == 0:
        if reads:
            flat[0] += reads
        return leaves
    lib = _kernels.load()
    args = (seq.data_ptr(), qual.data_ptr(), lengths.data_ptr(),
            None if error_codes is None else error_codes.data_ptr(),
            flat.data_ptr(), n, min(n, max(n_rec, 0)), L, int(col_offset),
            int(offset), reads, int(bool(count_scalars)),
            int(bool(row_stats)), int(qual_hist_2d), _group(L),
            rows_per_block, cluster, _kernels.stream_ptr(dev))
    with _kernels.on_device(dev):
        err = lib.bs_qc_stats(*args)
    _kernels.check(err, "bs_qc_stats")
    qc_stats.launches += 1
    return leaves


def qc_stats(seq, qual, lengths, offset: int, n_records=None,
             error_codes=None, col_offset=0,
             count_scalars: bool = True, row_stats: bool = True,
             qual_hist_2d: bool = False, *, out=None) -> QCStats:
    """QCStats for one padded batch seq, qual u8[n, L], lengths int32[n].

    `n_records` (a host int) separates genuine records from padding rows.
    `col_offset` is the batch's starting column when it holds a column
    slice of longer records; `count_scalars=False` zeroes the per-record
    scalars and per-read panels (reads, bases, error_reads, the three row
    histograms), for every column slice but the first. CPU tensors run
    `qc_stats_torch`; CUDA tensors run the kernel (counted in
    `qc_stats.launches`) or raise. The leaves returned are views of one
    int32 buffer.

    `out`, a QCStats returned by an earlier call on a batch of the same
    width and `qual_hist_2d`, on the same device: the batch is added into
    it in place (int32 wraps, as QCStats.merge does) and `out` is
    returned. Another width or `qual_hist_2d`, or leaves that are not
    views of one such buffer, raise ValueError."""
    args = (seq, qual, lengths, offset, n_records, error_codes, col_offset,
            count_scalars, row_stats, qual_hist_2d)
    if seq.is_cuda:
        return _qc_stats_cuda(*args, out)
    if seq.device.type != "cpu":
        raise ValueError("qc_stats: unsupported device %s" % seq.device)
    base = (None if out is None else
            _total_buffer(out, seq.shape[1], bool(qual_hist_2d), seq.device))
    plain = qc_stats_torch(*args)
    flat = torch.cat([a.reshape(-1) for a in plain if a is not None])
    if base is None:
        return _views(flat, _layout(seq.shape[1], bool(qual_hist_2d)))
    base += flat
    return out


qc_stats.launches = 0


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
