"""k-mer spectrum over padded read batches (counterpart of
blazeseq_tpu/ops/kmer.py).

Exact counts of all 4^k DNA k-mers (k <= 8): 2-bit base codes (A=0 C=1 G=2
T=3, case-insensitive; anything else poisons the window). `kmer_counts`
dispatches on the batch's device: CUDA tensors run one launch of the
hand-written kernel in csrc/kmer.cu, which writes every bin (no fill; its
start tickets' state is kept by device and stream; counted in
`kmer_counts.launches`) or the call raises; CPU tensors run the plain torch version
`kmer_counts_torch`: rolling window codes from k shifted adds and one
bincount, windows that leave the read or hold a non-ACGT byte taking a
sentinel bin past the last, which is dropped.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _kernels
from .common import _kept, check_cuda_batch, length_mask


def _check_k(k):
    if not 1 <= k <= 8:
        raise ValueError("k must be in 1..8 (4^k histogram bins)")


def kmer_counts_torch(seq, lengths, n_records=None, *,
                      k: int = 4) -> torch.Tensor:
    """Plain torch version of `kmer_counts`."""
    _check_k(k)
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


def _kmer_counts_cuda(seq, lengths, n_records, k):
    """One launch of csrc/kmer.cu into `torch.empty` bins (a batch with no
    row or no column: zeros, no launch). A row count on the card is read
    there, with no sync; one on the host is passed by value."""
    lengths = lengths.to(torch.int32)
    check_cuda_batch("kmer_counts", [("seq", seq)], [("lengths", lengths)])
    n, L = seq.shape
    dev = seq.device
    ptr, width, value = None, 0, n
    if isinstance(n_records, torch.Tensor):
        if n_records.numel() != 1:
            raise ValueError("kmer_counts: n_records must be one value")
        if n_records.is_cuda:
            if n_records.device != dev:
                raise ValueError("kmer_counts: n_records on %s, the batch on "
                                 "%s" % (n_records.device, dev))
            if n_records.dtype not in (torch.int32, torch.int64):
                n_records = n_records.to(torch.int64)
            ptr, width = n_records.data_ptr(), n_records.element_size()
        else:
            value = int(n_records)
    elif n_records is not None:
        value = int(n_records)
    if not (n and L):
        return torch.zeros(4 ** k, dtype=torch.int32, device=dev)
    out = torch.empty(4 ** k, dtype=torch.int32, device=dev)
    lib = _kernels.load()
    stream = _kernels.stream_ptr(dev)
    # the start tickets and the generation whose out is zero, which each
    # launch leaves ready for the next
    state = _kept("kmer_state", dev, stream, 2, torch.int64)
    with _kernels.on_device(dev):
        err = lib.bs_kmer_counts(
            seq.data_ptr(), lengths.data_ptr(), ptr, width,
            max(min(value, n), -1), out.data_ptr(), state.data_ptr(), n, L,
            k, _kernels.sm_count(dev.index), stream)
    _kernels.check(err, "bs_kmer_counts")
    kmer_counts.launches += 1
    return out




def kmer_counts(seq, lengths, n_records=None, *, k: int = 4) -> torch.Tensor:
    """Count all 4^k k-mers of a padded batch [n, L] -> i32[4^k] on its
    device. Windows lie inside the true read length (clipped to the padded
    width) of the first `n_records` rows (an int or a one-value tensor) and
    hold only ACGT. CPU tensors run `kmer_counts_torch`; CUDA tensors run
    the kernel (counted in `kmer_counts.launches`) or raise."""
    _check_k(k)
    if seq.is_cuda:
        return _kmer_counts_cuda(seq, lengths, n_records, k)
    if seq.device.type != "cpu":
        raise ValueError("kmer_counts: unsupported device %s" % seq.device)
    return kmer_counts_torch(seq, lengths, n_records, k=k)


kmer_counts.launches = 0


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
