"""Read-duplication profiling (counterpart of blazeseq_tpu/ops/dedup.py;
FastQC's "sequence duplication levels" panel).

The device hashes every read of a padded batch; the host counts how often
each hash repeats over a capped sample. Two wrapping 32-bit polynomial
hashes, with the true read length mixed in, make a 64-bit key. They must
equal the reference's bit for bit, since duplicate counts depend on their
collisions. torch has no wrapping uint32 arithmetic, so the hashes are
computed in int64 and masked to 32 bits after every product and every sum:
a byte (< 2^8) times a power (< 2^32) stays below 2^40, and a row sum of L
masked products below L * 2^32. That is `read_hashes_torch`, the plain
version; `read_hashes` dispatches on the tensors' device: CPU tensors take
the plain version, CUDA tensors the hand-written kernel in csrc/dedup.cu
(native wrapping uint32 arithmetic), or the call raises. `_read_hashes_into`
hashes the first rows of a batch into rows of a larger buffer, so that a
run's duplication sample lives in one tensor on the card.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _kernels
from .common import check_cuda_batch, length_mask

_BASE_A = 1000003
_BASE_B = 0x01000193  # FNV prime
_LEN_SALT_A = 2654435761
_LEN_SALT_B = 0x9E3779B1
_MASK = 0xFFFFFFFF


@functools.cache
def _powers(base: int, L: int, device: torch.device) -> torch.Tensor:
    """[1, b, b^2, ...] mod 2^32 as int64 on `device`, by repeated
    multiply-and-mask."""
    p = [1] * L
    for k in range(1, L):
        p[k] = (p[k - 1] * base) & _MASK
    return torch.tensor(p, dtype=torch.int64, device=device)


def read_hashes_torch(seq, lengths, n_records=None) -> torch.Tensor:
    """Plain torch version of `read_hashes`."""
    n, L = seq.shape
    dev = seq.device
    if n_records is None:
        n_records = n
    row_valid = torch.arange(n, device=dev) < int(n_records)
    mask = length_mask(lengths, L) & row_valid[:, None]
    s = torch.where(mask, seq, 0).to(torch.int64)
    lens = lengths.to(torch.int64) & _MASK  # the reference's uint32 cast
    out = []
    for base, salt in ((_BASE_A, _LEN_SALT_A), (_BASE_B, _LEN_SALT_B)):
        prod = (s * _powers(base, L, dev)[None, :]) & _MASK
        h = (prod.sum(1) & _MASK) + ((lens * salt) & _MASK)
        out.append(torch.where(row_valid, h & _MASK, _MASK))
    return torch.stack(out, 1)


def _read_hashes_into(seq, lengths, n_records, out, at, rows) -> None:
    """Hash rows [0, rows) of a padded batch into out[at:at + rows].

    `out` is int64 [N, 2] on the batch's device and holds uint32 values, as
    `read_hashes` returns them; rows of the batch at or past n_records (a
    host int, None for all) get the sentinel, and the other rows of `out`
    are left alone. CUDA tensors run the kernel (counted in
    `read_hashes.launches`) or raise; CPU tensors run `read_hashes_torch`
    on the first `rows` rows and copy the result in."""
    if seq.is_cuda:
        check_cuda_batch("read_hashes", [("seq", seq)], [("lengths", lengths)])
    elif seq.device.type != "cpu":
        raise ValueError("read_hashes: unsupported device %s" % seq.device)
    n = seq.shape[0]
    if not 0 <= rows <= n:
        raise ValueError("read_hashes: %d rows of a batch of %d" % (rows, n))
    if (out.dtype != torch.int64 or out.dim() != 2 or out.shape[1] != 2
            or not out.is_contiguous()):
        raise ValueError("read_hashes: out must be a contiguous int64 "
                         "[N, 2] tensor")
    if not (0 <= at and at + rows <= out.shape[0]):
        raise ValueError("read_hashes: rows [%d, %d) outside out's %d"
                         % (at, at + rows, out.shape[0]))
    if out.device != seq.device:
        raise ValueError("read_hashes: out on %s, the batch on %s"
                         % (out.device, seq.device))
    n_valid = n if n_records is None else min(n, max(int(n_records), 0))
    if not seq.is_cuda:
        out[at:at + rows] = read_hashes_torch(seq[:rows], lengths[:rows],
                                              min(n_valid, rows))
        return
    if rows == 0:
        return
    lib = _kernels.load()
    dev = seq.device
    # out[at] starts 16 * at bytes into out (contiguous int64 [N, 2])
    args = (seq.data_ptr(), lengths.data_ptr(), out.data_ptr() + 16 * at, n,
            n_valid, rows, seq.shape[1], _kernels.sm_count(dev.index),
            _kernels.stream_ptr(dev))
    with _kernels.on_device(dev):
        err = lib.bs_read_hashes(*args)
    _kernels.check(err, "bs_read_hashes")
    read_hashes.launches += 1


def read_hashes(seq, lengths, n_records=None) -> torch.Tensor:
    """Hash each read of a padded batch u8[n, L] -> int64[n, 2], each value
    a uint32 (in [0, 2^32)).

    Bytes past the true length are masked, the true length is mixed in;
    padding rows (row >= n_records, a host int) get the all-ones sentinel,
    which the host side drops. CPU tensors run `read_hashes_torch`; CUDA
    tensors run the kernel (counted in `read_hashes.launches`) or raise."""
    if not seq.is_cuda:
        if seq.device.type != "cpu":
            raise ValueError("read_hashes: unsupported device %s"
                             % seq.device)
        return read_hashes_torch(seq, lengths, n_records)
    n = seq.shape[0] if seq.dim() else 0
    out = torch.empty((n, 2), dtype=torch.int64, device=seq.device)
    _read_hashes_into(seq, lengths, n_records, out, 0, n)
    return out


read_hashes.launches = 0


def read_hashes_cpu(reads) -> np.ndarray:
    """Scalar host twin of `read_hashes` (padding-free), u32[n, 2]."""
    out = np.empty((len(reads), 2), np.uint64)
    for i, r in enumerate(reads):
        b = np.frombuffer(bytes(r), np.uint8).astype(np.uint64)
        pa = np.uint64(1)
        pb = np.uint64(1)
        ha = np.uint64(0)
        hb = np.uint64(0)
        m = np.uint64(0xFFFFFFFF)
        for x in b:
            ha = (ha + x * pa) & m
            hb = (hb + x * pb) & m
            pa = (pa * np.uint64(1000003)) & m
            pb = (pb * np.uint64(0x01000193)) & m
        out[i, 0] = (ha + np.uint64(len(b)) * np.uint64(2654435761)) & m
        out[i, 1] = (hb + np.uint64(len(b)) * np.uint64(0x9E3779B1)) & m
    return out.astype(np.uint32)


def duplication_levels(hashes: np.ndarray, max_level: int = 10):
    """FastQC duplication histogram from stacked u32[n, 2] hash batches.

    Returns (levels, frac_unique_reads): levels[k] (1 <= k < max_level) is
    the number of DISTINCT sequences seen exactly k times; levels[max_level]
    is distinct sequences seen >= max_level times; levels[0] unused."""
    h = np.ascontiguousarray(np.asarray(hashes, dtype=np.uint32))
    key = (h[:, 0].astype(np.uint64) << np.uint64(32)) \
        | h[:, 1].astype(np.uint64)
    n = key.shape[0]
    if n == 0:
        return np.zeros(max_level + 1, np.int64), 1.0
    _, counts = np.unique(key, return_counts=True)
    levels = np.bincount(np.minimum(counts, max_level),
                         minlength=max_level + 1).astype(np.int64)
    frac_unique = float((counts == 1).sum()) / n
    return levels, frac_unique


def overrepresented_sequences(hashes: np.ndarray, prefixes: np.ndarray,
                              min_fraction: float = 0.001,
                              top_k: int = 20) -> list:
    """FastQC's overrepresented-sequences table: sequences making up more
    than `min_fraction` of the tracked sample.

    `prefixes` are representative leading bytes (u8[n, <=50]) aligned
    row-for-row with `hashes`; the first occurrence's prefix labels each
    group. Returns [(prefix_bytes, count)] sorted most-frequent-first."""
    h = np.ascontiguousarray(np.asarray(hashes, dtype=np.uint32))
    key = (h[:, 0].astype(np.uint64) << np.uint64(32)) \
        | h[:, 1].astype(np.uint64)
    n = key.shape[0]
    if n == 0:
        return []
    _, first_idx, counts = np.unique(key, return_index=True,
                                     return_counts=True)
    hot = counts.astype(np.float64) / n > min_fraction
    hot &= counts > 1
    order = np.argsort(counts[hot])[::-1][:top_k]
    out = []
    for i in np.flatnonzero(hot)[order]:
        row = prefixes[first_idx[i]]
        out.append((row.tobytes().rstrip(b"\x00"), int(counts[i])))
    return out
