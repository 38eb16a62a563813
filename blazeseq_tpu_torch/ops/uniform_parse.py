"""Uniform-layout parsing (counterpart of
blazeseq_tpu/ops/uniform_parse.py; torch ops, no kernel).

Real FASTQ is mostly layout-uniform: one read length and one header width,
so the byte stream is an [n_records, record_size] matrix. The host reads the
layout from the first record; the device proves it for every record of a
chunk (`uniform_parse` here, or the one-pass QC kernel of
ops/uniform_qc.py) and slices the padded batch out of the matrix.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .common import AT, NEWLINE, PLUS


class UniformLayout(NamedTuple):
    """Relative newline offsets of one record (host-detected, device-proven).

    rs = record size in bytes; o1/o2/o3 = offsets of the 1st..3rd newline
    relative to the record start (the 4th is rs-1). Sequence bytes live in
    columns [o1+1, o2), quality bytes in [o3+1, rs-1).
    """

    rs: int
    o1: int
    o2: int
    o3: int

    @property
    def seq_len(self) -> int:
        return self.o2 - self.o1 - 1

    @property
    def qual_len(self) -> int:
        return self.rs - 1 - (self.o3 + 1)


def detect_uniform_layout(buf, start: int = 0) -> Optional[UniformLayout]:
    """Read the first record's newline layout from a bytes-like object.
    Returns None when no complete record exists at `start` or the candidate
    layout is structurally impossible (the device proof would reject it
    anyway; this avoids a wasted dispatch)."""
    view = bytes(memoryview(buf)[start : start + 65536])
    p1 = view.find(b"\n")
    if p1 < 0:
        return None
    p2 = view.find(b"\n", p1 + 1)
    if p2 < 0:
        return None
    p3 = view.find(b"\n", p2 + 1)
    if p3 < 0:
        return None
    p4 = view.find(b"\n", p3 + 1)
    if p4 < 0:
        return None
    lay = UniformLayout(rs=p4 + 1, o1=p1, o2=p2, o3=p3)
    if not view.startswith(b"@") or view[p2 + 1 : p2 + 2] != b"+":
        return None
    if lay.seq_len != lay.qual_len or lay.seq_len == 0:
        return None
    return lay


class UniformParseResult(NamedTuple):
    seq: torch.Tensor          # u8[nrec, width] padded sequence rows
    qual: torch.Tensor         # u8[nrec, width] padded quality rows
    lengths: torch.Tensor      # i32[nrec] true read length (0 past n_valid)
    n_records: torch.Tensor    # i32[] complete records in the valid region
    bases: torch.Tensor        # i32[] sequence bytes (n_records * seq_len)
    template_ok: torch.Tensor  # bool[] newline/marker template proven
    bad_ascii: torch.Tensor    # bool[] high bit present in a valid row
    bad_quality: torch.Tensor  # bool[] quality byte out of schema range


def uniform_parse(chunk, n_valid, q_lower, q_upper, *, rs: int, o1: int,
                  o2: int, o3: int, width: int, check_ascii: bool = True,
                  check_quality: bool = True,
                  fused_checks: bool = False) -> UniformParseResult:
    """Parse a (possibly zero-padded) u8 chunk under a uniform layout, on
    the chunk's device.

    chunk: u8[n] with n a multiple of rs; rows at or past n_valid // rs
    (n_valid: int or 0-d tensor, the count of real bytes) are excluded.
    q_lower / q_upper are taken mod 256, as the reference's uint8 casts do.

    fused_checks=True folds the template, ASCII and quality-range proofs
    into one pass: any violation reports as template_ok=False, and
    bad_ascii / bad_quality are always False."""
    n = chunk.shape[0]
    if n % rs:
        raise ValueError("uniform_parse: chunk length %d is not a multiple "
                         "of rs=%d" % (n, rs))
    dev = chunk.device
    nrec = n // rs
    seq_len = o2 - o1 - 1
    r2 = chunk.view(nrec, rs)
    nrec_valid = (torch.as_tensor(n_valid, device=dev).to(torch.int32)
                  // rs)
    row_valid = (torch.arange(nrec, dtype=torch.int32, device=dev)
                 < nrec_valid)[:, None]

    col = torch.arange(rs, device=dev)[None, :]
    tmpl = (col == o1) | (col == o2) | (col == o3) | (col == rs - 1)
    nl = r2 == NEWLINE
    marker_ok = (r2[:, 0:1] == AT) & (r2[:, o2 + 1:o2 + 2] == PLUS)
    qual_cols = r2[:, o3 + 1:rs - 1]
    lo, hi = int(q_lower) & 0xFF, int(q_upper) & 0xFF
    false = torch.zeros((), dtype=torch.bool, device=dev)

    if fused_checks:
        bad = nl != tmpl
        if check_ascii:
            bad |= (r2 & 0x80) != 0
        if check_quality:
            in_qual = (col >= o3 + 1) & (col < rs - 1)
            bad |= in_qual & ((r2 < lo) | (r2 > hi))
        row_bad = bad.any(1, keepdim=True) | ~marker_ok
        template_ok = ~(row_bad & row_valid).any()
        bad_ascii = bad_quality = false
    else:
        # the proof: the newline mask equals the column template exactly
        row_ok = (nl == tmpl).all(1, keepdim=True) & marker_ok
        template_ok = (row_ok | ~row_valid).all()
        bad_ascii = (((r2 & 0x80) != 0) & row_valid).any() if check_ascii \
            else false
        bad_quality = (((qual_cols < lo) | (qual_cols > hi))
                       & row_valid).any() if check_quality else false

    # padded batch: two column slices, zero past the window and the valid
    # rows
    w = min(seq_len, width)
    seq = torch.zeros((nrec, width), dtype=torch.uint8, device=dev)
    qual = torch.zeros((nrec, width), dtype=torch.uint8, device=dev)
    seq[:, :w] = r2[:, o1 + 1:o1 + 1 + w]
    qual[:, :w] = qual_cols[:, :w]
    seq.mul_(row_valid)
    qual.mul_(row_valid)
    lengths = torch.where(row_valid[:, 0], seq_len, 0).to(torch.int32)
    bases = nrec_valid * seq_len
    return UniformParseResult(seq, qual, lengths, nrec_valid, bases,
                              template_ok, bad_ascii, bad_quality)
