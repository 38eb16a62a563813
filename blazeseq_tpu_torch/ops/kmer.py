"""k-mer spectrum over padded read batches (counterpart of
blazeseq_tpu/ops/kmer.py; torch ops, no kernel).

Exact counts of all 4^k DNA k-mers (k <= 8): 2-bit base codes (A=0 C=1 G=2
T=3, case-insensitive; anything else poisons the window), rolling window
codes from k shifted adds, and one bincount. Windows that leave the read or
hold a non-ACGT byte take a sentinel bin past the last, which is dropped.
"""

from __future__ import annotations

import numpy as np
import torch

from .common import length_mask


def kmer_counts(seq, lengths, n_records=None, *, k: int = 4) -> torch.Tensor:
    """Count all 4^k k-mers of a padded batch [n, L] -> i32[4^k] on its
    device. Windows lie inside the true read length (clipped to the padded
    width) of the first `n_records` rows and hold only ACGT."""
    if not 1 <= k <= 8:
        raise ValueError("k must be in 1..8 (4^k histogram bins)")
    n, L = seq.shape
    dev = seq.device
    mask = length_mask(lengths, L)
    if n_records is not None:
        rows = torch.arange(n, dtype=torch.int32, device=dev)
        mask &= (rows < torch.as_tensor(n_records, device=dev))[:, None]

    upper = seq & 0xDF
    b2 = torch.full(seq.shape, 4, dtype=torch.int32, device=dev)
    for v, b in enumerate(b"ACGT"):
        b2 = torch.where(upper == b, v, b2)
    b2 = torch.where(mask, b2, 4)

    n_bins = 4 ** k
    code = torch.zeros(seq.shape, dtype=torch.int32, device=dev)
    ok = torch.ones(seq.shape, dtype=torch.bool, device=dev)
    for t in range(k):
        sh = torch.nn.functional.pad(b2[:, t:], (0, t), value=4) if t else b2
        ok &= sh < 4
        code += sh << (2 * (k - 1 - t))
    codes = torch.where(ok, code, n_bins).view(-1).to(torch.int64)
    return torch.bincount(codes, minlength=n_bins + 1)[:n_bins].to(
        torch.int32)


def kmer_counts_cpu(reads, k: int = 4) -> np.ndarray:
    """Scalar host twin of `kmer_counts` (padding-free)."""
    tr = {65: 0, 67: 1, 71: 2, 84: 3, 97: 0, 99: 1, 103: 2, 116: 3}
    out = np.zeros(4 ** k, np.int64)
    for r in reads:
        b = bytes(r)
        for j in range(len(b) - k + 1):
            code = 0
            for t in range(k):
                v = tr.get(b[j + t])
                if v is None:
                    code = None
                    break
                code = (code << 2) | v
            if code is not None:
                out[code] += 1
    return out
