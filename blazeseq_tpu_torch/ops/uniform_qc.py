"""One-pass uniform-layout FASTQ parse + validate + QC (counterpart of
blazeseq_tpu/ops/uniform_qc.py, whose TPU kernel is
blazeseq_tpu/ops/fused_qc.py::fused_uniform_qc).

A chunk of fixed-layout records is a [nrec, rs] byte matrix. One pass
proves the newline template, validates the bytes, and computes every
`QCStats` panel straight from the record matrix: position p of every read is
column o1+1+p (sequence) or o3+1+p (quality), so per-position panels are
column sums and no padded batch is ever built.

The pass has two implementations with the same raw outputs: the
hand-written kernel in csrc/uniform_qc.cu (CUDA tensors) and the plain torch
version `_uniform_qc_raw_torch` (CPU tensors, and the comparison on the
card). Both build the full 64-bin histogram of clip(q - offset, 0, 63); one
torch epilogue turns the raw outputs into `QCStats`, folding the eq-mode
histogram (`hist_vals`) there.
"""

from __future__ import annotations

import torch

from .. import _kernels
from .common import AT, NEWLINE, PLUS
from .stats import GC_BINS, LEN_BINS, MAX_PHRED, QCStats, bin_counts

_BASES = b"ACGT"
# dynamic shared memory one block may use on sm_90
_MAX_SMEM = 232448


def _uniform_qc_raw_torch(r2, nrec_valid, *, rs, o1, o2, o3, cnt, q_lo,
                          q_hi, offset, check_ascii, check_quality):
    """Plain torch version of the kernel's raw outputs: (bad int32[1],
    csq int32[cnt], csb int32[4, cnt], qh int32[64], gch int32[101],
    mqh int32[64])."""
    x = r2[:nrec_valid]  # rows past n_valid are padding: skipped
    col = torch.arange(rs, device=x.device)
    tmpl = (col == o1) | (col == o2) | (col == o3) | (col == rs - 1)
    bad = (x == NEWLINE) != tmpl
    if check_ascii:
        bad |= x > 127
    if check_quality:
        in_qual = (col >= o3 + 1) & (col < rs - 1)
        bad |= in_qual & ((x < q_lo) | (x > q_hi))
    bad_rows = bad.any(1) | (x[:, 0] != AT) | (x[:, o2 + 1] != PLUS)

    upper = x[:, o1 + 1:o1 + 1 + cnt] & 0xDF
    ph = torch.clamp(x[:, o3 + 1:o3 + 1 + cnt].to(torch.int32) - offset,
                     0, MAX_PHRED - 1)
    csb = torch.stack([(upper == b).sum(0, dtype=torch.int32)
                       for b in _BASES])
    gc_read = ((upper == ord("C")) | (upper == ord("G"))).sum(
        1, dtype=torch.int32)
    qs_read = ph.sum(1, dtype=torch.int32)
    gc_bin = torch.div(200 * gc_read + cnt, 2 * cnt, rounding_mode="floor")
    mq_bin = torch.clamp(torch.div(2 * qs_read + cnt, 2 * cnt,
                                   rounding_mode="floor"), max=MAX_PHRED - 1)
    return (bad_rows.sum(dtype=torch.int32).reshape(1),
            ph.sum(0, dtype=torch.int32), csb,
            bin_counts(ph, None, MAX_PHRED), bin_counts(gc_bin, None, GC_BINS),
            bin_counts(mq_bin, None, MAX_PHRED))


def _uniform_qc_raw_cuda(r2, nrec_valid, *, rs, o1, o2, o3, cnt, q_lo, q_hi,
                         offset, check_ascii, check_quality):
    """The kernel's raw outputs (see _uniform_qc_raw_torch)."""
    if not r2.is_cuda:
        raise ValueError("uniform_qc: chunk is not on a CUDA device (got %s)"
                         % r2.device)
    if not r2.is_contiguous():
        raise ValueError("uniform_qc: chunk must be contiguous")
    lib = _kernels.load()
    if lib.bs_uniform_qc_smem_bytes(cnt) > _MAX_SMEM:
        raise ValueError("uniform_qc: stats window of %d columns exceeds "
                         "the kernel's shared memory" % cnt)
    dev = r2.device
    # one zeroed allocation holds every output; the kernel adds into it
    out = torch.zeros(1 + 5 * cnt + 2 * MAX_PHRED + GC_BINS,
                      dtype=torch.int32, device=dev)
    sizes = (1, cnt, 4 * cnt, MAX_PHRED, GC_BINS, MAX_PHRED)
    bad, csq, csb, qh, gch, mqh = torch.split(out, sizes)
    with torch.cuda.device(dev):
        err = lib.bs_uniform_qc(
            r2.data_ptr(), nrec_valid, rs, o1, o2, o3, cnt, q_lo, q_hi,
            offset, int(bool(check_ascii)), int(bool(check_quality)),
            bad.data_ptr(), csq.data_ptr(), csb.data_ptr(), qh.data_ptr(),
            gch.data_ptr(), mqh.data_ptr(),
            2 * _kernels.sm_count(dev.index), _kernels.stream_ptr(dev))
    _kernels.check(err, "bs_uniform_qc")
    uniform_qc.launches += 1
    return bad, csq, csb.view(4, cnt), qh, gch, mqh


def _assemble(raw, nrec_valid, seq_len, cnt, width, hist_vals):
    """Raw per-chunk outputs -> (template_ok bool[], QCStats)."""
    bad, csq, csb, qh, gch, mqh = raw
    dev = qh.device
    nv = torch.full((), nrec_valid, dtype=torch.int32, device=dev)

    def window(row):
        # [cnt] per-position sums -> [width], zero past the window
        out = torch.zeros(width, dtype=torch.int32, device=dev)
        out[:cnt] = row
        return out

    acgt = [window(csb[k]) for k in range(4)]
    per_pos_count = window(nv.expand(cnt))
    other = per_pos_count - (acgt[0] + acgt[1] + acgt[2] + acgt[3])
    per_pos_base = torch.stack(acgt + [other])
    base_counts = per_pos_base.sum(1, dtype=torch.int32)
    if hist_vals:
        # eq-mode: keep the observed values' bins; every other in-window
        # byte lands in the remainder bin max+1, the caller's re-run signal
        # (scalar indexing only: an index tensor built on the host would
        # cost a blocking copy per chunk)
        qual_hist = torch.zeros(MAX_PHRED, dtype=torch.int32, device=dev)
        for v in set(hist_vals):
            qual_hist[v] = qh[v]
        qual_hist[max(hist_vals) + 1] = (
            nv * cnt - qual_hist.sum(dtype=torch.int32))
    else:
        qual_hist = qh
    length_hist = torch.zeros(LEN_BINS, dtype=torch.int32, device=dev)
    length_hist[min(seq_len, LEN_BINS - 1)] = nv
    stats = QCStats(
        reads=nv,
        bases=nv * seq_len,
        base_counts=base_counts,
        per_pos_base_counts=per_pos_base,
        per_pos_qual_sum=window(csq),
        per_pos_count=per_pos_count,
        qual_hist=qual_hist,
        gc_count=base_counts[1] + base_counts[2],
        error_reads=torch.zeros((), dtype=torch.int32, device=dev),
        length_hist=length_hist,
        gc_hist=gch,
        mean_qual_hist=mqh,
    )
    return bad[0] == 0, stats


def _run(raw_fn, chunk, n_valid, *, rs, o1, o2, o3, width, q_lo, q_hi,
         offset, check_ascii, check_quality, hist_vals):
    if chunk.dtype != torch.uint8:
        raise TypeError("uniform_qc: chunk must be uint8, got %s"
                        % chunk.dtype)
    if chunk.dim() == 2:
        if chunk.shape[1] != rs:
            raise ValueError("uniform_qc: 2-D chunk must be [nrec, rs]")
        r2 = chunk
    elif chunk.dim() == 1:
        if chunk.shape[0] % rs:
            raise ValueError("uniform_qc: chunk length must be padded to a "
                             "multiple of rs")
        r2 = chunk.view(-1, rs)
    else:
        raise ValueError("uniform_qc: chunk must be 1-D or 2-D")
    if not 0 < o1 < o2 < o3 < rs - 1:
        raise ValueError("uniform_qc: newline offsets out of order")
    nrec_valid = int(n_valid) // rs
    if not 0 <= nrec_valid <= r2.shape[0]:
        raise ValueError("uniform_qc: n_valid %d outside the chunk"
                         % int(n_valid))
    seq_len = o2 - o1 - 1
    cnt = min(seq_len, width)
    if cnt < 1:
        raise ValueError("uniform_qc: empty stats window")
    n_bins = (min(q_hi - offset, MAX_PHRED - 1) + 1 if check_quality
              else MAX_PHRED)
    n_bins = max(1, min(n_bins, MAX_PHRED))
    # eq-mode preconditions: phred v <-> byte offset+v needs q_lo >= offset,
    # and the remainder bin max+1 must lie inside the histogram
    hist_vals = tuple(hist_vals) if check_quality else ()
    if hist_vals and not (q_lo >= offset and min(hist_vals) >= 0
                          and max(hist_vals) + 1 < n_bins):
        raise ValueError("uniform_qc: hist_vals outside the eq-mode "
                         "preconditions")
    raw = raw_fn(r2, nrec_valid, rs=rs, o1=o1, o2=o2, o3=o3, cnt=cnt,
                 q_lo=int(q_lo), q_hi=int(q_hi), offset=int(offset),
                 check_ascii=check_ascii, check_quality=check_quality)
    return _assemble(raw, nrec_valid, seq_len, cnt, width, hist_vals)


def uniform_qc_torch(chunk, n_valid, *, rs: int, o1: int, o2: int, o3: int,
                     width: int, q_lo: int, q_hi: int, offset: int,
                     check_ascii: bool = True, check_quality: bool = True,
                     hist_vals: tuple = ()):
    """Plain torch version of `uniform_qc`, on any device."""
    return _run(_uniform_qc_raw_torch, chunk, n_valid, rs=rs, o1=o1, o2=o2,
                o3=o3, width=width, q_lo=q_lo, q_hi=q_hi, offset=offset,
                check_ascii=check_ascii, check_quality=check_quality,
                hist_vals=hist_vals)


def uniform_qc(chunk, n_valid, *, rs: int, o1: int, o2: int, o3: int,
               width: int, q_lo: int, q_hi: int, offset: int,
               check_ascii: bool = True, check_quality: bool = True,
               hist_vals: tuple = ()):
    """Parse + validate + QC one uniform-layout chunk.

    chunk: u8[nrec, rs], or u8[n] with n % rs == 0. Rows at or beyond
    n_valid // rs are padding and excluded. Returns (template_ok bool[],
    stats QCStats); the stats are meaningful only when template_ok, and a
    rejected chunk goes to the exact host path.

    `hist_vals` (() = off) is the caller-observed set of distinct Phred
    values: the histogram keeps those bins and counts every other
    in-window byte in a remainder bin at max(hist_vals)+1; the caller
    re-runs with full bins when the accumulated remainder is nonzero.

    CPU tensors run the plain torch version; CUDA tensors run the kernel
    (counted in `uniform_qc.launches`) or raise."""
    if chunk.is_cuda:
        raw_fn = _uniform_qc_raw_cuda
    elif chunk.device.type == "cpu":
        raw_fn = _uniform_qc_raw_torch
    else:
        raise ValueError("uniform_qc: unsupported device %s" % chunk.device)
    return _run(raw_fn, chunk, n_valid, rs=rs, o1=o1, o2=o2, o3=o3,
                width=width, q_lo=q_lo, q_hi=q_hi, offset=offset,
                check_ascii=check_ascii, check_quality=check_quality,
                hist_vals=hist_vals)


uniform_qc.launches = 0
