"""Batched read-vs-reference alignment scores (counterpart of
blazeseq_tpu/ops/nw.py).

Global Needleman-Wunsch with +1 match / -1 mismatch / -1 gap,
dp[0][j] = -j, dp[i][0] = -i, and a read's score at dp[len][Lr]:

* `nw_scores` dispatches on the tensors' device: CPU tensors take
  `nw_scores_torch`, CUDA tensors the hand-written kernel in csrc/nw.cu
  (counted in `nw_scores.launches`), or the call raises.
* `nw_scores_torch` is the plain torch version: the anti-diagonal wavefront
  of the reference's `nw_scores_xla`, D = Lq + Lr steps over [B, Lq + 1].

The local (Smith-Waterman), affine-gap (Gotoh) and semi-global variants had
no Pallas kernel in the reference; they are its wavefronts in torch ops.
The numpy scalar twins are copies of the reference's, for validation.

Reads are a padded u8[B, Lq] batch with int32 lengths (<= Lq; the callers
clamp); the reference is a u8[Lr] tensor with Lr >= 1. A read's score
depends only on its first `len` bytes and on the whole reference.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _kernels

NEG = -(10**9) // 2


# ---------------------------------------------------------------- twins

def needleman_wunsch_cpu(query: bytes, ref: bytes,
                         match: int = 1, mismatch: int = -1,
                         gap: int = -1) -> int:
    """Scalar host twin of the global linear-gap score."""
    q = np.frombuffer(bytes(query), dtype=np.uint8)
    r = np.frombuffer(bytes(ref), dtype=np.uint8)
    m, n = len(q), len(r)
    g = -gap  # positive gap penalty
    prev = (np.arange(n + 1, dtype=np.int32) * gap).astype(np.int32)
    ar = np.arange(n, dtype=np.int32)
    for i in range(1, m + 1):
        cur = np.empty(n + 1, dtype=np.int32)
        cur[0] = i * gap
        sub = np.where(r == q[i - 1], match, mismatch).astype(np.int32)
        best = np.maximum(prev[:-1] + sub, prev[1:] + gap)
        # left-gap dependency cur[j+1] = max(best[j], cur[j] + gap) resolved
        # in closed form: cur[j+1] = max(runmax(best[k] + g*k)[j],
        # cur[0]+gap) - g*j
        b = best + g * ar
        run = np.maximum(np.maximum.accumulate(b), cur[0] + gap)
        cur[1:] = run - g * ar
        prev = cur
    return int(prev[n])


def smith_waterman_cpu(query: bytes, ref: bytes, match: int = 1,
                       mismatch: int = -1, gap: int = -1) -> int:
    """Scalar host twin of the local (Smith-Waterman) score."""
    Lq, Lr = len(query), len(ref)
    prev = [0] * (Lr + 1)
    best = 0
    for i in range(1, Lq + 1):
        cur = [0] * (Lr + 1)
        for j in range(1, Lr + 1):
            s = match if query[i - 1] == ref[j - 1] else mismatch
            cur[j] = max(0, prev[j - 1] + s, prev[j] + gap, cur[j - 1] + gap)
            if cur[j] > best:
                best = cur[j]
        prev = cur
    return best


def needleman_wunsch_affine_cpu(query: bytes, ref: bytes, match: int = 1,
                                mismatch: int = -1, gap_open: int = -3,
                                gap_extend: int = -1) -> int:
    """Scalar host twin of the global affine-gap (Gotoh) score."""
    q = bytes(query)
    r = bytes(ref)
    m, n = len(q), len(r)
    M = np.full((m + 1, n + 1), NEG, np.int64)
    Ix = np.full((m + 1, n + 1), NEG, np.int64)
    Iy = np.full((m + 1, n + 1), NEG, np.int64)
    M[0, 0] = 0
    for i in range(1, m + 1):
        Ix[i, 0] = gap_open + (i - 1) * gap_extend
    for j in range(1, n + 1):
        Iy[0, j] = gap_open + (j - 1) * gap_extend
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            sub = match if q[i - 1] == r[j - 1] else mismatch
            M[i, j] = max(M[i - 1, j - 1], Ix[i - 1, j - 1],
                          Iy[i - 1, j - 1]) + sub
            Ix[i, j] = max(M[i - 1, j] + gap_open,
                           Ix[i - 1, j] + gap_extend)
            Iy[i, j] = max(M[i, j - 1] + gap_open,
                           Iy[i, j - 1] + gap_extend)
    return int(max(M[m, n], Ix[m, n], Iy[m, n]))


def smith_waterman_affine_cpu(query: bytes, ref: bytes, match: int = 1,
                              mismatch: int = -1, gap_open: int = -3,
                              gap_extend: int = -1) -> int:
    """Scalar host twin of the local affine-gap (SW-Gotoh) score."""
    q = bytes(query)
    r = bytes(ref)
    m, n = len(q), len(r)
    H = np.zeros((m + 1, n + 1), np.int64)
    E = np.full((m + 1, n + 1), NEG, np.int64)  # gap in query (consumes ref)
    F = np.full((m + 1, n + 1), NEG, np.int64)  # gap in ref (consumes query)
    best = 0
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            sub = match if q[i - 1] == r[j - 1] else mismatch
            E[i, j] = max(H[i, j - 1] + gap_open, E[i, j - 1] + gap_extend)
            F[i, j] = max(H[i - 1, j] + gap_open, F[i - 1, j] + gap_extend)
            H[i, j] = max(0, H[i - 1, j - 1] + sub, E[i, j], F[i, j])
            if H[i, j] > best:
                best = int(H[i, j])
    return best


def semiglobal_cpu(query: bytes, ref: bytes, match: int = 1,
                   mismatch: int = -1, gap: int = -1) -> int:
    """Scalar host twin: free leading/trailing ref gaps, full query."""
    q = bytes(query)
    r = bytes(ref)
    m, n = len(q), len(r)
    prev = [0] * (n + 1)
    for i in range(1, m + 1):
        cur = [i * gap] + [0] * n
        for j in range(1, n + 1):
            sub = match if q[i - 1] == r[j - 1] else mismatch
            cur[j] = max(prev[j - 1] + sub, prev[j] + gap, cur[j - 1] + gap)
        prev = cur
    return int(max(prev))


def semiglobal_affine_cpu(query: bytes, ref: bytes, match: int = 1,
                          mismatch: int = -1, gap_open: int = -3,
                          gap_extend: int = -1) -> int:
    """Scalar host twin: semi-global with affine (Gotoh) gaps."""
    q = bytes(query)
    r = bytes(ref)
    m, n = len(q), len(r)
    M = np.full((m + 1, n + 1), NEG, np.int64)
    Ix = np.full((m + 1, n + 1), NEG, np.int64)
    Iy = np.full((m + 1, n + 1), NEG, np.int64)
    M[0, :] = 0  # free leading ref skip (fresh start at any ref offset)
    for i in range(1, m + 1):
        Ix[i, 0] = gap_open + (i - 1) * gap_extend
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            sub = match if q[i - 1] == r[j - 1] else mismatch
            M[i, j] = max(M[i - 1, j - 1], Ix[i - 1, j - 1],
                          Iy[i - 1, j - 1]) + sub
            Ix[i, j] = max(M[i - 1, j] + gap_open,
                           Ix[i - 1, j] + gap_extend)
            Iy[i, j] = max(M[i, j - 1] + gap_open,
                           Iy[i, j - 1] + gap_extend)
    return int(max(M[m].max(), Ix[m].max(), Iy[m].max()))


# ---------------------------------------------------------------- wavefronts

def _check_ref(ref):
    if ref.dim() != 1 or ref.shape[0] == 0:
        raise ValueError("alignment needs a non-empty 1-D reference, got "
                         "shape %s" % (tuple(ref.shape),))


class _Wavefront:
    """What every wavefront shares: seq_shift[b, i] = q[b, i-1] (0 at
    i = 0), the lane index i, and RD[d-1, i] = ref[d-1-i] (0xFF where out of
    range) for the diagonals d = 1..Lq+Lr."""

    def __init__(self, seq, lengths, ref):
        _check_ref(ref)
        B, Lq = seq.shape
        dev = seq.device
        self.B, self.Lq, self.Lr = B, Lq, int(ref.shape[0])
        self.D = Lq + self.Lr
        self.i_idx = torch.arange(Lq + 1, dtype=torch.int32,
                                  device=dev)[None, :]
        self.seq_shift = torch.cat(
            [torch.zeros((B, 1), dtype=torch.uint8, device=dev), seq], 1)
        d_idx = torch.arange(1, self.D + 1, dtype=torch.int64,
                             device=dev)[:, None]
        j = d_idx - 1 - self.i_idx.to(torch.int64)
        valid = (j >= 0) & (j < self.Lr)
        self.RD = torch.where(valid, ref[j.clamp(0, self.Lr - 1)],
                              torch.full_like(ref[:1], 0xFF))
        self.lengths = lengths.to(torch.int32)

    def sub(self, d: int, match: int, mismatch: int):
        hit = self.seq_shift == self.RD[d - 1][None, :]
        return torch.where(hit, match, mismatch).to(torch.int32)

    def full(self, value: int):
        return torch.full((self.B, self.Lq + 1), value, dtype=torch.int32,
                          device=self.seq_shift.device)

    def at_len(self, cell):
        """cell[b, lengths[b]] (0 where the length has no lane)."""
        lens = self.lengths
        got = cell.gather(1, lens.clamp(0, self.Lq).to(torch.int64)[:, None])
        return torch.where((lens >= 0) & (lens <= self.Lq), got[:, 0], 0)

    def local_valid(self, d: int):
        i = self.i_idx
        return ((i >= 1) & (i <= self.lengths[:, None]) & (i <= d - 1)
                & (i >= d - self.Lr))


def _roll(x):
    return torch.roll(x, 1, dims=1)


def nw_scores_torch(seq, lengths, ref, match: int = 1, mismatch: int = -1,
                    gap: int = -1):
    """Plain torch version: batched global scores, i32[B]. A row of length
    0 scores Lr * gap (the pure-gap alignment dp[0][Lr])."""
    w = _Wavefront(seq, lengths, ref)
    target_d = w.lengths + w.Lr
    prev1 = w.full(0)  # diagonal 0: only cell (0, 0) = 0 is used
    prev2 = w.full(0)
    score = torch.full((w.B,), NEG, dtype=torch.int32, device=seq.device)
    for d in range(1, w.D + 1):
        new = torch.maximum(
            torch.maximum(_roll(prev2) + w.sub(d, match, mismatch),
                          _roll(prev1) + gap), prev1 + gap)
        new = torch.where((w.i_idx == 0) | (w.i_idx == d), d * gap, new)
        score = torch.where(target_d == d, w.at_len(new), score)
        prev1, prev2 = new, prev1
    return score


def sw_scores(seq, lengths, ref, match: int = 1, mismatch: int = -1,
              gap: int = -1):
    """Batched Smith-Waterman (local) scores, i32[B]: cells clamp at 0 and
    the score is the running max over valid cells (0 for empty reads)."""
    w = _Wavefront(seq, lengths, ref)
    prev1 = w.full(0)
    prev2 = w.full(0)
    best = torch.zeros(w.B, dtype=torch.int32, device=seq.device)
    for d in range(1, w.D + 1):
        new = torch.maximum(
            torch.maximum(_roll(prev2) + w.sub(d, match, mismatch),
                          _roll(prev1) + gap), prev1 + gap)
        new = torch.clamp(new, min=0)
        new = torch.where((w.i_idx == 0) | (w.i_idx == d), 0, new)
        best = torch.maximum(
            best, torch.where(w.local_valid(d), new, 0).amax(1))
        prev1, prev2 = new, prev1
    return best


def nw_affine_scores(seq, lengths, ref, match: int = 1, mismatch: int = -1,
                     gap_open: int = -3, gap_extend: int = -1):
    """Batched global affine-gap (Gotoh) scores, i32[B]: a length-k gap
    costs gap_open + (k-1) * gap_extend."""
    w = _Wavefront(seq, lengths, ref)
    go, ge = gap_open, gap_extend
    target_d = w.lengths + w.Lr
    m1 = torch.where(w.i_idx == 0, 0, w.full(NEG))
    x1, y1, m2, x2, y2 = (w.full(NEG) for _ in range(5))
    score = torch.full((w.B,), NEG, dtype=torch.int32, device=seq.device)
    for d in range(1, w.D + 1):
        best2 = torch.maximum(torch.maximum(m2, x2), y2)
        Mn = _roll(best2) + w.sub(d, match, mismatch)
        Xn = torch.maximum(_roll(m1) + go, _roll(x1) + ge)
        Yn = torch.maximum(m1 + go, y1 + ge)
        edge = go + (d - 1) * ge
        on0 = w.i_idx == 0  # j = d: top boundary row
        ond = w.i_idx == d  # j = 0: left boundary column
        Mn = torch.where(on0 | ond, NEG, Mn)
        Xn = torch.where(on0, NEG, torch.where(ond, edge, Xn))
        Yn = torch.where(ond, NEG, torch.where(on0, edge, Yn))
        cell = torch.maximum(torch.maximum(Mn, Xn), Yn)
        score = torch.where(target_d == d, w.at_len(cell), score)
        m1, x1, y1, m2, x2, y2 = Mn, Xn, Yn, m1, x1, y1
    return score


def sw_affine_scores(seq, lengths, ref, match: int = 1, mismatch: int = -1,
                     gap_open: int = -3, gap_extend: int = -1):
    """Batched local affine-gap (SW-Gotoh) scores, i32[B] (0 floor)."""
    w = _Wavefront(seq, lengths, ref)
    go, ge = gap_open, gap_extend
    h1, h2 = w.full(0), w.full(0)
    e1, f1 = w.full(NEG), w.full(NEG)
    best = torch.zeros(w.B, dtype=torch.int32, device=seq.device)
    for d in range(1, w.D + 1):
        En = torch.maximum(h1 + go, e1 + ge)
        Fn = torch.maximum(_roll(h1) + go, _roll(f1) + ge)
        Hn = torch.maximum(
            torch.maximum(_roll(h2) + w.sub(d, match, mismatch), En),
            torch.clamp(Fn, min=0))
        on_edge = (w.i_idx == 0) | (w.i_idx == d)
        Hn = torch.where(on_edge, 0, Hn)
        En = torch.where(on_edge, NEG, En)
        Fn = torch.where(on_edge, NEG, Fn)
        best = torch.maximum(
            best, torch.where(w.local_valid(d), Hn, 0).amax(1))
        h1, e1, f1, h2 = Hn, En, Fn, h1
    return best


def nw_semiglobal_scores(seq, lengths, ref, match: int = 1,
                         mismatch: int = -1, gap: int = -1):
    """Batched semi-global scores, i32[B]: the whole read aligns, leading
    and trailing reference bases are free (0 for empty reads)."""
    w = _Wavefront(seq, lengths, ref)
    prev1 = w.full(0)
    prev2 = w.full(0)
    best = torch.full((w.B,), NEG, dtype=torch.int32, device=seq.device)
    for d in range(1, w.D + 1):
        new = torch.maximum(
            torch.maximum(_roll(prev2) + w.sub(d, match, mismatch),
                          _roll(prev1) + gap), prev1 + gap)
        new = torch.where(w.i_idx == 0, 0, new)  # free leading ref skip
        new = torch.where(w.i_idx == d, d * gap, new)  # leading query gap
        take = (d >= w.lengths) & (d <= w.lengths + w.Lr)
        best = torch.where(take, torch.maximum(best, w.at_len(new)), best)
        prev1, prev2 = new, prev1
    return torch.where(w.lengths == 0, 0, best)


def nw_semiglobal_affine_scores(seq, lengths, ref, match: int = 1,
                                mismatch: int = -1, gap_open: int = -3,
                                gap_extend: int = -1):
    """Batched semi-global affine-gap scores, i32[B]."""
    w = _Wavefront(seq, lengths, ref)
    go, ge = gap_open, gap_extend
    m1 = torch.where(w.i_idx == 0, 0, w.full(NEG))
    x1, y1, m2, x2, y2 = (w.full(NEG) for _ in range(5))
    best = torch.full((w.B,), NEG, dtype=torch.int32, device=seq.device)
    for d in range(1, w.D + 1):
        best2 = torch.maximum(torch.maximum(m2, x2), y2)
        Mn = _roll(best2) + w.sub(d, match, mismatch)
        Xn = torch.maximum(_roll(m1) + go, _roll(x1) + ge)
        Yn = torch.maximum(m1 + go, y1 + ge)
        edge = go + (d - 1) * ge
        on0 = w.i_idx == 0
        ond = w.i_idx == d
        Mn = torch.where(on0, 0, torch.where(ond, NEG, Mn))
        Xn = torch.where(on0, NEG, torch.where(ond, edge, Xn))
        Yn = torch.where(on0 | ond, NEG, Yn)
        cell = torch.maximum(torch.maximum(Mn, Xn), Yn)
        take = (d >= w.lengths) & (d <= w.lengths + w.Lr)
        best = torch.where(take, torch.maximum(best, w.at_len(cell)), best)
        m1, x1, y1, m2, x2, y2 = Mn, Xn, Yn, m1, x1, y1
    return torch.where(w.lengths == 0, 0, best)


# ---------------------------------------------------------------- kernel

def _check_inputs(seq, lengths, ref):
    for name, t, dt in (("seq", seq, torch.uint8),
                        ("lengths", lengths, torch.int32),
                        ("ref", ref, torch.uint8)):
        if not t.is_cuda:
            raise ValueError("nw_scores: %s is not on a CUDA device (got %s)"
                             % (name, t.device))
        if t.dtype != dt:
            raise TypeError("nw_scores: %s must be %s, got %s"
                            % (name, dt, t.dtype))
        if not t.is_contiguous():
            raise ValueError("nw_scores: %s must be contiguous" % name)
    if seq.dim() != 2 or lengths.shape != (seq.shape[0],):
        raise ValueError("nw_scores: seq must be [B, Lq] and lengths [B], "
                         "got %s and %s" % (tuple(seq.shape),
                                            tuple(lengths.shape)))
    if not (seq.device == lengths.device == ref.device):
        raise ValueError("nw_scores: inputs on different devices")


def _nw_scores_cuda(seq, lengths, ref):
    _check_inputs(seq, lengths, ref)
    lib = _kernels.load()
    B, Lq = seq.shape
    Lr = int(ref.shape[0])
    scores = torch.empty(B, dtype=torch.int32, device=seq.device)
    # the boundary column handed from one reference tile to the next
    scratch = torch.empty((Lq + 1, B), dtype=torch.int32, device=seq.device)
    with torch.cuda.device(seq.device):
        err = lib.bs_nw_scores(seq.data_ptr(), lengths.data_ptr(),
                               ref.data_ptr(), scores.data_ptr(),
                               scratch.data_ptr(), B, Lq, Lr,
                               _kernels.stream_ptr(seq.device))
    _kernels.check(err, "bs_nw_scores")
    nw_scores.launches += 1
    return scores


def nw_scores(seq, lengths, ref):
    """Global +1/-1/-1 scores of a padded batch against `ref`, i32[B]. CPU
    tensors run the plain torch version; CUDA tensors run the kernel
    (counted in `nw_scores.launches`) or raise. An empty reference raises
    ValueError."""
    _check_ref(ref)
    if seq.is_cuda:
        return _nw_scores_cuda(seq, lengths, ref)
    if seq.device.type != "cpu":
        raise ValueError("nw_scores: unsupported device %s" % seq.device)
    return nw_scores_torch(seq, lengths, ref)


nw_scores.launches = 0
