"""The least bytes and int32 operations of the port's kernels, frozen from
the bring-up tools' arithmetic (chip_smoke.py: kernel B's chunk bound,
kernel_a_bound, qc_stats_bound, adapter_bound, hash_bound, cli_op_bound).
Each input byte counts once, each output byte once; the work that depends
on the data (an adapter scan that stops at a read's first hit) counts what
these inputs need. Every function returns (bytes, ops)."""

from __future__ import annotations

import numpy as np

QC_STATS_OPS_PER_POSITION = 10
HASH_OPS_PER_BYTE = 4
CLI_OPS_PER_BYTE = 3
# kernel B's QCStats sums: 1 + 5 cnt + 64 + 101 + 64 int32
_KERNEL_B_SUMS = (1, 5, 64 + 101 + 64)


def kernel_b(chunk_bytes: float, records: float, cnt: int, rs: float,
             launches: int = 1):
    """uniform_qc over chunks of `records` records of `rs` bytes in all:
    the chunks read once, each launch's sums written once; two operations a
    window position and one a 4-byte word of the layout proof."""
    sums = _KERNEL_B_SUMS[0] + _KERNEL_B_SUMS[1] * cnt + _KERNEL_B_SUMS[2]
    return (chunk_bytes + 4 * sums * launches,
            records * (2 * cnt + np.ceil(rs / 4)))


def validate(lengths: np.ndarray, L: int):
    """validate_decode of a padded batch: seq and qual read where a row's
    length reaches, Phred written whole, lengths and codes; a range test, a
    high-bit test and the subtract a byte."""
    n = len(lengths)
    inlen = np.clip(lengths.astype(np.int64), 0, L).sum()
    return 2 * int(inlen) + n * L + 8 * n, 5 * n * L


def qc_stats(lengths: np.ndarray, L: int, n_valid: int, qual_hist_2d: bool):
    """qc_stats: seq and qual read where a record reaches, lengths and
    codes of the records, the leaves written once."""
    inlen = int(np.clip(lengths[:n_valid].astype(np.int64), 0, L).sum())
    leaves = 750 + 7 * L + (64 * L if qual_hist_2d else 0)
    return (2 * inlen + 8 * n_valid + 4 * leaves,
            QC_STATS_OPS_PER_POSITION * inlen)


def adapters(read_upto: np.ndarray, starts: int, n_valid: int, n_ad: int,
             L: int):
    """The multi-adapter scan: each record read up to the end of the last
    adapter's first hit (to its length where one has none), one compare a
    start column up to each adapter's first hit, lengths and the panels.
    `read_upto` and `starts` come from the reads themselves
    (metrics/_lib.adapter_scan_work)."""
    return (int(read_upto.sum()) + 4 * n_valid + 4 * n_ad * (L + 2),
            int(starts))


def hashes(lengths: np.ndarray, L: int, n: int, n_valid: int):
    """read_hashes: each hashed record read up to its length, the lengths,
    16 bytes written a row."""
    inlen = int(np.clip(lengths[:n_valid], 0, L).astype(np.int64).sum())
    return inlen + 4 * n + 16 * n, HASH_OPS_PER_BYTE * inlen


def trim(lengths: np.ndarray, L: int, out_bytes_per_row: int = 4):
    """One trim call on a padded batch: each row's bytes in length read
    once, the lengths read and the new lengths written; three operations a
    byte."""
    n = len(lengths)
    b = int(np.clip(lengths.astype(np.int64), 0, L).sum())
    return b + 4 * n + out_bytes_per_row * n, CLI_OPS_PER_BYTE * b
