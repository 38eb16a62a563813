"""Adapter-content scanning over padded read batches (counterpart of
blazeseq_tpu/ops/adapter.py; FastQC's adapter panel).

For a short adapter a[0..la), m[i, j] = all_k(seq[i, j+k] == a[k]) as `la`
shifted compares, case-folded with `& 0xDF`; columns shifted in past the
row are 0x00, which never matches. A match counts only when it fits in the
read: j + la <= min(len, L). FastQC's cumulative curve is the prefix sum of
the first-occurrence counts.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class AdapterStats(NamedTuple):
    """Additive per-batch adapter occurrence statistics (int32 tensors on
    the device, or int64 numpy arrays in a report)."""

    first_occurrence: torch.Tensor  # [L] reads whose FIRST hit starts at j
    reads_with_adapter: torch.Tensor  # [] reads with >= 1 full occurrence
    reads_scanned: torch.Tensor  # []

    def merge(self, other: "AdapterStats") -> "AdapterStats":
        return AdapterStats(*(a + b for a, b in zip(self, other)))

    def cumulative_fraction(self) -> np.ndarray:
        """FastQC curve: fraction of reads with a hit at or before column j."""
        tot = max(int(self.reads_scanned), 1)
        return np.cumsum(np.asarray(self.first_occurrence),
                         dtype=np.float64) / tot

    def to_numpy(self) -> "AdapterStats":
        return AdapterStats(*(np.asarray(torch.as_tensor(a).cpu(), np.int64)
                              for a in self))


def _adapter_matches(seq, lengths, adapter_host: bytes):
    n, L = seq.shape
    la = len(adapter_host)
    upper = seq & 0xDF
    hit = torch.ones((n, L), dtype=torch.bool, device=seq.device)
    for k, byte in enumerate(adapter_host):
        # seq column j+k against adapter byte k; past the row: 0x00
        shifted = torch.zeros_like(upper)
        if k < L:
            shifted[:, : L - k] = upper[:, k:]
        hit &= shifted == (byte & 0xDF)
    j_idx = torch.arange(L, dtype=torch.int32, device=seq.device)[None, :]
    fit = torch.clamp(lengths.to(torch.int32), max=L)[:, None]
    return hit & (j_idx + la <= fit)


def adapter_content(seq, lengths, n_records=None, *,
                    adapter_host: bytes) -> AdapterStats:
    """Scan one padded batch u8[n, L] for `adapter_host`. `n_records` (a
    host int; None means every row) separates genuine reads from padding
    rows. Returns first-occurrence counts per start column, the number of
    reads with at least one occurrence, and the number of reads scanned."""
    n, L = seq.shape
    if n_records is None:
        n_records = n
    row_valid = torch.arange(n, device=seq.device) < int(n_records)
    hit = _adapter_matches(seq, lengths, bytes(adapter_host)) \
        & row_valid[:, None]
    # first occurrence: a hit at j with no hit strictly before j
    first = hit & (torch.cumsum(hit, 1) == 1)
    return AdapterStats(
        first_occurrence=first.sum(0, dtype=torch.int32),
        reads_with_adapter=hit.any(1).sum(dtype=torch.int32),
        reads_scanned=torch.full((), int(n_records), dtype=torch.int32,
                                 device=seq.device),
    )


def adapter_content_cpu(reads, adapter: bytes, max_len=None):
    """Scalar host twin: (first_occurrence list, reads_with_adapter)."""
    ad = bytes(adapter).upper()
    L = max_len if max_len is not None else max(
        (len(r) for r in reads), default=0)
    first = [0] * L
    with_hit = 0
    for r in reads:
        pos = bytes(r).upper().find(ad)
        if pos >= 0 and pos < L:
            first[pos] += 1
            with_hit += 1
    return first, with_hit
