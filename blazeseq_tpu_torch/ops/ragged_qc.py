"""General (ragged-layout) FASTQ parse + validate + QC of one chunk
(counterpart of blazeseq_tpu/ops/ragged_qc.py::ragged_qc, which is XLA code
and reaches no Pallas kernel).

A chunk starts at a record boundary; its header widths and read lengths vary
per record. One call validates every complete record and computes every
`QCStats` panel with the host engine's truncation semantics
(`FastqParser.padded_batches` + `ops/stats.qc_stats` at `width` columns):
`bases` and `length_hist` use true lengths; composition, the per-position
panels, the Phred histogram and the per-read GC% and mean-quality bins
cover each line's first `width` bytes.

The pass has two implementations with the same raw outputs: the
hand-written kernel in csrc/ragged_qc.cu (CUDA tensors: one pass over
tiles of TILE_BYTES, each staged in shared memory, its newlines' phase
from a look-back over the tiles before) and the plain torch
version `_ragged_qc_raw_torch` (CPU tensors, and the comparison on the
card). Both build full-bin histograms (64 Phred bins of
clip(q - offset, 0, 63), 512 length bins) and a histogram of in-window seq
lengths from which the per-position read count follows; one torch epilogue
turns the raw outputs into `QCStats`, folding the eq-mode histograms
(`hist_vals`, `len_vals`) there.

The reference's TPU design (MXU cross-correlations over a [tiles, K] view,
rank-compacted slots, "no gather, no scatter, no sort") and its knobs
`slot_cap` and `_ablate` are not ported: the port has no slot structure and
no lag correlation. `fallback` stays for API parity and is always False
here: the kernel takes records of any length and tiles of any density, so
every chunk fits. Chunks the reference sends to `fallback` (slot overflow,
records shorter than min(longest line, width)) stay on the device in the
port, and their stats equal the host engine's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import _kernels
from .common import AT, NEWLINE, PLUS
from .stats import GC_BINS, LEN_BINS, MAX_PHRED, QCStats

# offsets are int32 on the card
_MAX_BYTES = (1 << 31) - 1
# bytes per tile of the kernel (csrc/ragged_qc.cu's kTile, which refuses
# another): a warp stages each tile with a halo in shared memory, and each
# tile has one int32 status word for the look-back
TILE_BYTES = 2048


def tile_count(address: int, n_valid: int) -> int:
    """Tiles of the kernel over a chunk at `address` with `n_valid` bytes:
    tiles start at the address rounded down to 16 bytes."""
    if n_valid <= 0:
        return 0
    return -(-(address % 16 + n_valid) // TILE_BYTES)


class RaggedQC(NamedTuple):
    ok: torch.Tensor          # bool[] validation passed (stats trustworthy)
    fallback: torch.Tensor    # bool[] always False in the port (see above)
    tail_start: torch.Tensor  # i32[] offset of the trailing partial record
    stats: QCStats


def raw_sizes(width: int) -> tuple:
    """Sizes of the raw outputs, in order: bad, tail_start, reads, bases,
    in-window seq length histogram [width + 1], A/C/G/T per position
    [4 * width], Phred sum per position [width], Phred histogram [64],
    length histogram [512], GC% bins [101], mean-quality bins [64]."""
    return (1, 1, 1, 1, width + 1, 4 * width, width, MAX_PHRED, LEN_BINS,
            GC_BINS, MAX_PHRED)


def _split(flat, width):
    parts = list(torch.split(flat, raw_sizes(width)))
    parts[5] = parts[5].view(4, width)
    return tuple(parts)


def _bincount(idx, n):
    """int64[n] counts of the int64 indices `idx` (all in [0, n))."""
    out = torch.zeros(n, dtype=torch.int64, device=idx.device)
    return out.scatter_add_(0, idx, torch.ones_like(idx))


def _ragged_qc_raw_torch(x, n_valid, *, width, q_lo, q_hi, offset,
                         check_ascii, check_quality):
    """Plain torch version of the kernel's raw outputs: one int32 tensor of
    sum(raw_sizes(width)) entries (see raw_sizes)."""
    dev = x.device
    i64 = torch.int64
    parts = [torch.zeros(s, dtype=i64, device=dev) for s in raw_sizes(width)]
    bad, tail, reads, bases, effh, csb, csq, qh, lh, gch, mqh = parts
    v = x[:n_valid]
    nl = torch.nonzero(v == NEWLINE).flatten()
    n_rec = nl.numel() // 4
    if n_rec:
        t = int(nl[4 * n_rec - 1]) + 1
        body = v[:t]
        P = nl[:4 * n_rec].view(n_rec, 4)
        starts = torch.cat([P.new_zeros(1), P[:-1, 3] + 1])
        ls = P[:, 1] - P[:, 0] - 1
        lq = P[:, 3] - P[:, 2] - 1
        bad_rec = ((body[starts] != AT) | (body[P[:, 1] + 1] != PLUS)
                   | (ls != lq))
        # every byte's line (its newline belongs to it), phase and column
        isnl = body == NEWLINE
        line = torch.cumsum(isnl, 0) - isnl.to(i64)
        line_start = torch.cat([nl.new_zeros(1), nl[:4 * n_rec - 1] + 1])
        col = torch.arange(t, device=dev) - line_start[line]
        phase = line & 3
        seq_b = (phase == 1) & ~isnl
        qual_b = (phase == 3) & ~isnl
        b = body.to(i64)
        any_bad = bad_rec.any()
        if check_ascii:
            any_bad |= (b > 127).any()
        if check_quality:
            any_bad |= (qual_b & ((b < q_lo) | (b > q_hi))).any()
        bad += any_bad.to(i64)
        tail += t
        reads += n_rec
        bases += ls.sum()

        sw = seq_b & (col < width)
        up = b[sw] & 0xDF
        scol, srec = col[sw], (line[sw] >> 2)
        for k, base in enumerate(b"ACGT"):
            csb.view(4, width)[k] = _bincount(scol[up == base], width)
        cg = torch.zeros(n_rec, dtype=i64, device=dev).scatter_add_(
            0, srec, ((up == ord("C")) | (up == ord("G"))).to(i64))
        qwm = qual_b & (col < width)
        ph = torch.clamp(b[qwm] - offset, 0, MAX_PHRED - 1)
        qcol, qrec = col[qwm], (line[qwm] >> 2)
        csq += torch.zeros(width, dtype=i64, device=dev).scatter_add_(
            0, qcol, ph)
        qh += _bincount(ph, MAX_PHRED)
        qs = torch.zeros(n_rec, dtype=i64, device=dev).scatter_add_(
            0, qrec, ph)
        eff = torch.clamp(ls, max=width)
        effq = torch.clamp(lq, max=width)
        effh += _bincount(eff, width + 1)
        lh += _bincount(torch.clamp(ls, max=LEN_BINS - 1), LEN_BINS)
        has = ls > 0
        gch += _bincount(torch.div(200 * cg[has] + eff[has], 2 * eff[has],
                                   rounding_mode="floor"), GC_BINS)
        hasq = lq > 0
        mq = torch.div(2 * qs[hasq] + effq[hasq], 2 * effq[hasq],
                       rounding_mode="floor")
        mqh += _bincount(torch.clamp(mq, max=MAX_PHRED - 1), MAX_PHRED)
    return torch.cat([p.reshape(-1) for p in parts]).to(torch.int32)


def _ragged_qc_raw_cuda(x, n_valid, *, width, q_lo, q_hi, offset,
                        check_ascii, check_quality):
    """The kernel's raw outputs (see _ragged_qc_raw_torch), in one pass
    and without a host sync: bs_ragged_qc takes tiles of TILE_BYTES in
    order (tiles start at the chunk's address rounded down to 16 bytes), a
    warp stages each with a halo in shared memory, counts its newlines,
    learns their phase from the tiles before by a look-back over one
    status word per tile, and parses the records that start in it.
    Scratch: one int32 per tile and a counter (0.5 MiB for a 256 MiB
    chunk), zeroed with the raw outputs in one fill."""
    if not x.is_cuda:
        raise ValueError("ragged_qc: chunk is not on a CUDA device (got %s)"
                         % x.device)
    if not x.is_contiguous():
        raise ValueError("ragged_qc: chunk must be contiguous")
    lib = _kernels.load()
    dev = x.device
    n_raw = sum(raw_sizes(width))
    # the raw outputs, which the kernel adds into, then the status words
    buf = torch.zeros(n_raw + tile_count(x.data_ptr(), n_valid) + 1,
                      dtype=torch.int32, device=dev)
    with _kernels.on_device(dev):
        err = lib.bs_ragged_qc(
            x.data_ptr(), buf[n_raw:].data_ptr(), n_valid, TILE_BYTES,
            width, q_lo, q_hi, offset, int(bool(check_ascii)),
            int(bool(check_quality)), buf.data_ptr(),
            _kernels.sm_count(dev.index), _kernels.stream_ptr(dev))
    _kernels.check(err, "bs_ragged_qc")
    ragged_qc.launches += 1
    return buf[:n_raw]


def _assemble(flat, width, hist_vals, len_vals) -> RaggedQC:
    """Raw outputs -> RaggedQC, with the eq-mode histograms folded."""
    (bad, tail, reads, bases, effh, csb, csq, qh, lh, gch,
     mqh) = _split(flat, width)
    dev = flat.device
    # reads whose in-window length exceeds p, for every position p
    per_pos_count = torch.flip(torch.cumsum(torch.flip(effh[1:], (0,)), 0,
                                            dtype=torch.int32), (0,))
    per_pos_base = torch.cat([csb, (per_pos_count - csb.sum(
        0, dtype=torch.int32))[None]])
    base_counts = per_pos_base.sum(1, dtype=torch.int32)
    # eq-mode: keep the observed values' bins; the rest of the reads or
    # bytes land in a remainder bin at max+1
    # (scalar indexing only: an index tensor built on the host would cost
    # a blocking copy per chunk)
    if hist_vals:
        qual_hist = torch.zeros(MAX_PHRED, dtype=torch.int32, device=dev)
        for v in set(hist_vals):
            qual_hist[v] = qh[v]
        qual_hist[max(hist_vals) + 1] = (qh.sum(dtype=torch.int32)
                                         - qual_hist.sum(dtype=torch.int32))
    else:
        qual_hist = qh
    if len_vals:
        length_hist = torch.zeros(LEN_BINS, dtype=torch.int32, device=dev)
        for v in set(len_vals):
            length_hist[v] = lh[v]
        length_hist[max(len_vals) + 1] = (
            reads[0] - length_hist.sum(dtype=torch.int32))
    else:
        length_hist = lh
    stats = QCStats(
        reads=reads[0],
        bases=bases[0],
        base_counts=base_counts,
        per_pos_base_counts=per_pos_base,
        per_pos_qual_sum=csq,
        per_pos_count=per_pos_count,
        qual_hist=qual_hist,
        gc_count=base_counts[1] + base_counts[2],
        error_reads=torch.zeros((), dtype=torch.int32, device=dev),
        length_hist=length_hist,
        gc_hist=gch,
        mean_qual_hist=mqh,
    )
    return RaggedQC(ok=bad[0] == 0,
                    fallback=torch.zeros((), dtype=torch.bool, device=dev),
                    tail_start=tail[0], stats=stats)


def _run(raw_fn, chunk, n_valid, *, width, q_lo, q_hi, offset, check_ascii,
         check_quality, hist_vals, len_vals) -> RaggedQC:
    if chunk.dtype != torch.uint8:
        raise TypeError("ragged_qc: chunk must be uint8, got %s" % chunk.dtype)
    if chunk.dim() not in (1, 2):
        raise ValueError("ragged_qc: chunk must be 1-D or 2-D")
    x = chunk.reshape(-1)
    n_valid = int(n_valid)
    if not 0 <= n_valid <= min(x.numel(), _MAX_BYTES):
        raise ValueError("ragged_qc: n_valid %d outside the chunk"
                         % n_valid)
    width = int(width)
    if width < 1:
        raise ValueError("ragged_qc: empty stats window")
    n_bins = (min(q_hi - offset, MAX_PHRED - 1) + 1 if check_quality
              else MAX_PHRED)
    n_bins = max(1, min(n_bins, MAX_PHRED))
    # eq-mode preconditions: phred v <-> byte offset+v needs q_lo >= offset,
    # and each remainder bin max+1 must lie inside its histogram
    hist_vals = tuple(hist_vals) if check_quality else ()
    if hist_vals and not (q_lo >= offset and min(hist_vals) >= 0
                          and max(hist_vals) + 1 < n_bins):
        raise ValueError("ragged_qc: hist_vals outside the eq-mode "
                         "preconditions")
    len_vals = tuple(len_vals)
    if len_vals and not (min(len_vals) >= 0
                         and max(len_vals) + 1 < LEN_BINS):
        raise ValueError("ragged_qc: len_vals needs a remainder bin")
    flat = raw_fn(x, n_valid, width=width, q_lo=int(q_lo), q_hi=int(q_hi),
                  offset=int(offset), check_ascii=bool(check_ascii),
                  check_quality=bool(check_quality))
    return _assemble(flat, width, hist_vals, len_vals)


def ragged_qc_torch(chunk, n_valid, *, width: int, q_lo: int, q_hi: int,
                    offset: int, check_ascii: bool = True,
                    check_quality: bool = True, hist_vals: tuple = (),
                    len_vals: tuple = ()) -> RaggedQC:
    """Plain torch version of `ragged_qc`, on any device."""
    return _run(_ragged_qc_raw_torch, chunk, n_valid, width=width, q_lo=q_lo,
                q_hi=q_hi, offset=offset, check_ascii=check_ascii,
                check_quality=check_quality, hist_vals=hist_vals,
                len_vals=len_vals)


def ragged_qc(chunk, n_valid, *, width: int, q_lo: int, q_hi: int,
              offset: int, check_ascii: bool = True,
              check_quality: bool = True, hist_vals: tuple = (),
              len_vals: tuple = ()) -> RaggedQC:
    """Parse + validate + QC one general FASTQ chunk.

    chunk: u8[n] (or any 2-D u8 tensor, read row-major) starting at a record
    boundary; bytes past `n_valid` are padding. `tail_start` is the offset
    just past the last complete record's 4th newline. `ok` is False when a
    complete record has an id line not starting with '@', a separator line
    not starting with '+', seq and qual lines of two lengths, a byte with
    the high bit set (check_ascii) or a quality byte outside [q_lo, q_hi]
    (check_quality, on the whole quality line); the stats are meaningful
    only when `ok`. Phred is clip(q - offset, 0, 63); a read of length 0
    counts in `reads` and `length_hist` only.

    The stats are int32, as the reference's: every sum is exact for chunks
    up to 2**28 bytes (QCModel's ragged tier cuts no larger ones).

    `hist_vals` / `len_vals` (() = off) are caller-observed sets of Phred
    values / clipped read lengths, as the reference's op takes them: each
    histogram keeps those bins and counts everything else in a remainder
    bin at max+1. Both are folded from the full bins after the pass, so
    they save no work here; QCModel's ragged tier passes neither.

    CPU tensors run the plain torch version; CUDA tensors run the kernel
    (counted in `ragged_qc.launches`) or raise."""
    if chunk.is_cuda:
        raw_fn = _ragged_qc_raw_cuda
    elif chunk.device.type == "cpu":
        raw_fn = _ragged_qc_raw_torch
    else:
        raise ValueError("ragged_qc: unsupported device %s" % chunk.device)
    return _run(raw_fn, chunk, n_valid, width=width, q_lo=q_lo, q_hi=q_hi,
                offset=offset, check_ascii=check_ascii,
                check_quality=check_quality, hist_vals=hist_vals,
                len_vals=len_vals)


ragged_qc.launches = 0
