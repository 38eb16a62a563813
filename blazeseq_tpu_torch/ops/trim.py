"""Quality trimming over padded batches, lengths only (counterpart of
blazeseq_tpu/ops/trim.py; torch ops, no kernel).

Every downstream op masks by `lengths`, so trimming computes new lengths
(and, for clip_ends, a start) and moves no bytes:

* clip_ends: Trimmomatic LEADING/TRAILING;
* sliding_window_trim: Trimmomatic SLIDINGWINDOW:window:mean_q;
* bwa_trim: BWA -q / seqtk trimfq 3' trimming.

Each has a scalar host twin (`*_cpu`). Lengths are first clipped to the
padded width: positions past it cannot be inspected.
"""

from __future__ import annotations

import torch

from .common import length_mask

_BIG = 1 << 30


def _phred(qual, offset):
    """Decoded Phred in int32, 0 below the offset."""
    q = qual.to(torch.int32)
    off = int(offset)
    return torch.where(q >= off, q - off, 0)


def _lens(qual, lengths):
    return lengths.to(torch.int32).clamp(max=qual.shape[1])


def _cols(qual):
    return torch.arange(qual.shape[1], dtype=torch.int32,
                        device=qual.device)[None, :]


def clip_ends(qual, lengths, offset, leading=3, trailing=3):
    """Trimmomatic LEADING/TRAILING: returns (start i32[n], new_len i32[n]);
    the kept slice is [start, start + new_len) of each read. Bases with
    quality < leading are dropped from the 5' end, < trailing from the
    3' end."""
    lens = _lens(qual, lengths)
    mask = length_mask(lens, qual.shape[1])
    q = _phred(qual, offset)
    j = _cols(qual)
    # first kept index (lens if none), last kept index + 1 (0 if none)
    start = torch.where(mask & (q >= int(leading)), j, _BIG).amin(1)
    start = torch.minimum(start, lens)
    end = torch.where(mask & (q >= int(trailing)), j + 1, 0).amax(1)
    new_len = (end - start).clamp(min=0)
    return start.to(torch.int32), new_len.to(torch.int32)


def clip_ends_cpu(qual: bytes, offset: int, leading=3, trailing=3):
    q = [max(b - offset, 0) for b in qual]
    start = 0
    while start < len(q) and q[start] < leading:
        start += 1
    end = len(q)
    while end > start and q[end - 1] < trailing:
        end -= 1
    return start, end - start


def sliding_window_trim(qual, lengths, offset, mean_q=15, *,
                        window: int = 4):
    """Trimmomatic SLIDINGWINDOW:window:mean_q: scan 5' -> 3'; at the first
    window whose mean quality drops below mean_q, cut the read at the
    window's start. Returns new lengths i32[n]."""
    n, L = qual.shape
    lens = _lens(qual, lengths)
    mask = length_mask(lens, L)
    q = torch.where(mask, _phred(qual, offset), 0)
    # window j covers [j, j + window): a difference of running sums
    c = torch.cumsum(q, 1, dtype=torch.int32)
    c = torch.cat([c.new_zeros((n, 1)), c], 1)
    wsum = c[:, window:] - c[:, :-window]
    j = torch.arange(wsum.shape[1], dtype=torch.int32,
                     device=qual.device)[None, :]
    # windows fully inside the read; compared in integers: sum < mean * w
    bad = (j + window <= lens[:, None]) & (wsum < int(mean_q) * window)
    cut = torch.where(bad, j, _BIG).amin(1)
    return torch.minimum(cut, lens).to(torch.int32)


def sliding_window_trim_cpu(qual: bytes, offset: int, mean_q=15, window=4):
    q = [max(b - offset, 0) for b in qual]
    for j in range(0, len(q) - window + 1):
        if sum(q[j:j + window]) < mean_q * window:
            return j
    return len(q)


def bwa_trim(qual, lengths, offset, threshold=20):
    """BWA -q / seqtk trimfq 3' trimming: cut at the position maximising the
    running sum of (threshold - q) taken from the 3' end; ties keep the
    longer read. Returns new lengths i32[n]."""
    lens = _lens(qual, lengths)
    mask = length_mask(lens, qual.shape[1])
    d = torch.where(mask, int(threshold) - _phred(qual, offset), 0)
    # s[:, k] = sum of d over [k, len)
    c = torch.cumsum(d, 1, dtype=torch.int32)
    s = torch.where(mask, c[:, -1:] - c + d, -_BIG)
    best = s.amax(1)
    # the LARGEST k reaching the max keeps the most bases
    best_k = torch.where(s == best[:, None], _cols(qual), -1).amax(1)
    return torch.where(best > 0, best_k.clamp(min=0), lens).to(torch.int32)


def bwa_trim_cpu(qual: bytes, offset: int, threshold=20):
    q = [max(b - offset, 0) for b in qual]
    best, best_k, s = 0, len(q), 0
    for k in range(len(q) - 1, -1, -1):
        s += threshold - q[k]
        if s > best:
            best, best_k = s, k
    return best_k if best > 0 else len(q)
