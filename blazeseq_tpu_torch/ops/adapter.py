"""Adapter-content scanning over padded read batches (counterpart of
blazeseq_tpu/ops/adapter.py; FastQC's adapter panel).

For a short adapter a[0..la), m[i, j] = all_k(seq[i, j+k] == a[k]) as `la`
shifted compares, case-folded with `& 0xDF`; columns shifted in past the
row are 0x00, which never matches. A match counts only when it fits in the
read: j + la <= min(len, L). FastQC's cumulative curve is the prefix sum of
the first-occurrence counts.

`adapter_content_torch` is the plain torch version; `adapter_content`
dispatches on the tensors' device: CPU tensors take the plain version, CUDA
tensors the hand-written kernel in csrc/adapter.cu (one launch an
adapter), or the call raises.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import _kernels
from .common import check_cuda_batch


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


def adapter_content_torch(seq, lengths, n_records=None, *,
                          adapter_host: bytes) -> AdapterStats:
    """Plain torch version of `adapter_content`."""
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


@functools.cache
def _folded(adapter_host: bytes, device: torch.device) -> torch.Tensor:
    """The adapter's bytes & 0xDF as u8 on `device` (at least one byte, so
    that the kernel always has a pointer)."""
    folded = bytes(b & 0xDF for b in adapter_host) or b"\0"
    return torch.frombuffer(bytearray(folded), dtype=torch.uint8).to(device)


def _adapter_content_cuda(seq, lengths, n_records, adapter_host):
    check_cuda_batch("adapter_content", [("seq", seq)],
                     [("lengths", lengths)])
    n, L = seq.shape
    dev = seq.device
    n_rec = n if n_records is None else int(n_records)
    # first_occurrence [L], reads_with_adapter, reads_scanned: one buffer
    flat = torch.zeros(L + 2, dtype=torch.int32, device=dev)
    adapter = _folded(bytes(adapter_host), dev)
    lib = _kernels.load()
    args = (seq.data_ptr(), lengths.data_ptr(), adapter.data_ptr(),
            flat.data_ptr(), min(n, max(n_rec, 0)), L, len(adapter_host),
            n_rec, _kernels.sm_count(dev.index), _kernels.stream_ptr(dev))
    with _kernels.on_device(dev):
        err = lib.bs_adapter_content(*args)
    _kernels.check(err, "bs_adapter_content")
    adapter_content.launches += 1
    return AdapterStats(flat[:L], flat[L], flat[L + 1])


def adapter_content(seq, lengths, n_records=None, *,
                    adapter_host: bytes) -> AdapterStats:
    """Scan one padded batch u8[n, L] for `adapter_host`. `n_records` (a
    host int; None means every row) separates genuine reads from padding
    rows. Returns first-occurrence counts per start column, the number of
    reads with at least one occurrence, and the number of reads scanned.
    CPU tensors run `adapter_content_torch`; CUDA tensors run the kernel
    (counted in `adapter_content.launches`) or raise."""
    if seq.is_cuda:
        return _adapter_content_cuda(seq, lengths, n_records, adapter_host)
    if seq.device.type != "cpu":
        raise ValueError("adapter_content: unsupported device %s"
                         % seq.device)
    return adapter_content_torch(seq, lengths, n_records,
                                 adapter_host=adapter_host)


adapter_content.launches = 0


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
