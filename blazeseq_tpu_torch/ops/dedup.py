"""Read-duplication profiling (counterpart of blazeseq_tpu/ops/dedup.py;
FastQC's "sequence duplication levels" panel).

The device hashes every read of a padded batch; the host counts how often
each hash repeats over a capped sample. Two wrapping 32-bit polynomial
hashes, with the true read length mixed in, make a 64-bit key. They must
equal the reference's bit for bit, since duplicate counts depend on their
collisions. torch has no wrapping uint32 arithmetic, so the hashes are
computed in int64 and masked to 32 bits after every product and every sum:
a byte (< 2^8) times a power (< 2^32) stays below 2^40, and a row sum of L
masked products below L * 2^32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .common import length_mask

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


def read_hashes(seq, lengths, n_records=None) -> torch.Tensor:
    """Hash each read of a padded batch u8[n, L] -> int64[n, 2], each value
    a uint32 (in [0, 2^32)).

    Bytes past the true length are masked, the true length is mixed in;
    padding rows (row >= n_records, a host int) get the all-ones sentinel,
    which the host side drops."""
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
