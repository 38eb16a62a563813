"""Paired-end overlap merging, PEAR-style (counterpart of
blazeseq_tpu/ops/merge.py; torch ops, no kernel).

For each (R1, R2) pair: reverse-complement R2, score every overlap length o
(the suffix of R1 against the prefix of rc(R2)) as
`matches - mismatch_penalty * mismatches`, and accept the best o with
o >= min_overlap and a mismatch fraction <= max_mismatch_frac. Ties keep
the smallest o. Merged reads take the higher-quality base (and its
quality) at overlap mismatches.

R1 is right-aligned once (a row gather); a loop over o compares R1's last o
columns with rc(R2)'s first o, about ten launches per o. O(n L) memory,
O(n L^2) compute: an analysis op, not an ingest-path op.

Host twin: `merge_pairs_host` (pure Python).
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

_COMP = np.full(256, ord("N"), dtype=np.uint8)
for _a, _b in zip(b"ACGTacgtN", b"TGCATGCAN"):
    _COMP[_a] = _b
_NEG = -(1 << 30)


class MergeResult(NamedTuple):
    overlap: torch.Tensor     # i32[n] accepted overlap length (0 = unmerged)
    merged_len: torch.Tensor  # i32[n] len1 + len2 - overlap (0 = unmerged)
    score: torch.Tensor       # i32[n] best score
    mismatches: torch.Tensor  # i32[n] mismatches at the accepted overlap
    seq: torch.Tensor         # u8[n, 2L] merged bases (zero-padded)
    qual: torch.Tensor        # u8[n, 2L] merged qualities


def _revcomp_rows(seq, qual, lengths):
    """Per-row reverse complement (and reversed qualities) of left-aligned
    padded reads, left-aligned again."""
    n, L = seq.shape
    j = torch.arange(L, device=seq.device)[None, :]
    src = (lengths[:, None].to(torch.int64) - 1 - j).clamp(0, L - 1)
    comp = torch.from_numpy(_COMP).to(seq.device)
    rc = comp[torch.gather(seq, 1, src).to(torch.int64)]
    rq = torch.gather(qual, 1, src)
    valid = j < lengths[:, None]
    return torch.where(valid, rc, 0), torch.where(valid, rq, 0)


def _score_overlaps(r1_right, rc2, len1, len2, min_overlap: int,
                    mismatch_penalty: int):
    """Best (score, overlap, mismatches) per row; the update is strict, so
    on ties the smallest o wins. Overlaps below min_overlap are never
    feasible and are skipped."""
    n, L = r1_right.shape
    best_s = torch.full((n,), _NEG, dtype=torch.int32, device=rc2.device)
    best_o = torch.zeros((n,), dtype=torch.int32, device=rc2.device)
    best_m = torch.zeros((n,), dtype=torch.int32, device=rc2.device)
    shortest = torch.minimum(len1, len2)
    for o in range(max(int(min_overlap), 1), L + 1):
        m = (r1_right[:, L - o:] == rc2[:, :o]).sum(1, dtype=torch.int32)
        s = m - mismatch_penalty * (o - m)
        s = torch.where(o <= shortest, s, _NEG)
        take = s > best_s
        best_s = torch.where(take, s, best_s)
        best_o = torch.where(take, o, best_o)
        best_m = torch.where(take, o - m, best_m)
    return best_s, best_o, best_m


def merge_pairs(seq1, qual1, len1, seq2, qual2, len2,
                min_overlap: int = 10, mismatch_penalty: int = 1,
                max_mismatch_frac: float = 0.25) -> MergeResult:
    """Merge padded read pairs on their device. seq2/qual2 are as sequenced
    (this function reverse-complements them). All [n, L] u8 tensors;
    lengths i32[n]."""
    n, L = seq1.shape
    dev = seq1.device
    len1 = len1.to(torch.int32)
    len2 = len2.to(torch.int32)
    rc2, rq2 = _revcomp_rows(seq2, qual2, len2)

    # right-align R1 so every read's suffix ends at column L
    j = torch.arange(L, device=dev)[None, :]
    src = j - (L - len1[:, None].to(torch.int64))
    srcc = src.clamp(0, L - 1)
    r1_right = torch.where(src >= 0, torch.gather(seq1, 1, srcc), 0)

    score, o, mism = _score_overlaps(r1_right, rc2, len1, len2, min_overlap,
                                     mismatch_penalty)
    frac_ok = mism.to(torch.float32) <= (
        torch.tensor(max_mismatch_frac, dtype=torch.float32, device=dev)
        * o.to(torch.float32))
    ok = (o > 0) & (score > 0) & frac_ok
    o = torch.where(ok, o, 0)
    mism = torch.where(ok, mism, 0)
    merged_len = torch.where(ok, len1 + len2 - o, 0)

    # consensus over [n, 2L]: position k takes R1 for k < len1 - o, the
    # higher-quality base inside the overlap, rc(R2) afterwards
    k = torch.arange(2 * L, device=dev)[None, :]
    pre = (len1 - o)[:, None].to(torch.int64)
    idx1 = k.clamp(0, L - 1).expand(n, -1)
    s1 = torch.gather(seq1, 1, idx1)
    q1 = torch.gather(qual1, 1, idx1)
    idx2 = (k - pre).clamp(0, L - 1)
    s2 = torch.gather(rc2, 1, idx2)
    q2 = torch.gather(rq2, 1, idx2)
    in1 = k < len1[:, None]
    use2 = (k >= pre) & in1 & (q2 > q1)
    seq_m = torch.where(in1, torch.where(use2, s2, s1), s2)
    qual_m = torch.where(in1, torch.where(use2, q2, q1), q2)
    valid = (k < merged_len[:, None]) & ok[:, None]
    return MergeResult(o, merged_len, torch.where(ok, score, 0), mism,
                       torch.where(valid, seq_m, 0).to(torch.uint8),
                       torch.where(valid, qual_m, 0).to(torch.uint8))


def _revcomp_b(s: bytes) -> bytes:
    return bytes(_COMP[b] for b in reversed(s))


def merge_pairs_host(r1: List[Tuple[bytes, bytes]],
                     r2: List[Tuple[bytes, bytes]],
                     min_overlap: int = 10, mismatch_penalty: int = 1,
                     max_mismatch_frac: float = 0.25):
    """Scalar host twin: list of (seq, qual) pairs -> list of
    (overlap, merged_seq, merged_qual) with overlap 0 = unmerged."""
    out = []
    for (s1, q1), (s2, q2) in zip(r1, r2):
        rc = _revcomp_b(s2)
        rq = bytes(reversed(q2))
        best = (-(1 << 30), 0, 0)
        for o in range(1, min(len(s1), len(rc)) + 1):
            if o < min_overlap:
                continue
            a = s1[len(s1) - o:]
            b = rc[:o]
            m = sum(1 for x, y in zip(a, b) if x == y)
            x = o - m
            s = m - mismatch_penalty * x
            if s > best[0]:
                best = (s, o, x)
        s, o, x = best
        if o == 0 or s <= 0 or x > max_mismatch_frac * o:
            out.append((0, b"", b""))
            continue
        pre = len(s1) - o
        seq = bytearray(s1[:pre])
        qual = bytearray(q1[:pre])
        for i in range(o):
            if rq[i] > q1[pre + i]:
                seq.append(rc[i])
                qual.append(rq[i])
            else:
                seq.append(s1[pre + i])
                qual.append(q1[pre + i])
        seq += rc[o:]
        qual += rq[o:]
        out.append((o, bytes(seq), bytes(qual)))
    return out
