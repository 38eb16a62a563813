"""Uniform-layout detection (counterpart of the host half of
blazeseq_tpu/ops/uniform_parse.py).

Real FASTQ is mostly layout-uniform: one read length and one header width,
so the byte stream is an [n_records, record_size] matrix. The host reads the
layout from the first record; the device step (ops/uniform_qc.py) proves it
for every record of a chunk.
"""

from __future__ import annotations

from typing import NamedTuple, Optional


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
