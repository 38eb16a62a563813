"""FAI index records (reference: blazeseq/fai/record.mojo).

A .fai row: NAME LENGTH OFFSET LINEBASES LINEWIDTH [QUALOFFSET] — 5 columns
for FASTA, 6 for FASTQ."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class FaiRecord:
    Name: bytes
    Length: int
    Offset: int
    LineBases: int
    LineWidth: int
    QualOffset: Optional[int] = None

    def name(self) -> str:
        return self.Name.decode("utf-8", "replace")

    def length(self) -> int:
        return self.Length

    def offset(self) -> int:
        return self.Offset

    def line_bases(self) -> int:
        return self.LineBases

    def line_width(self) -> int:
        return self.LineWidth

    def qual_offset(self) -> Optional[int]:
        return self.QualOffset

    def __len__(self) -> int:
        return self.Length

    def to_bytes(self) -> bytes:
        fields = [self.Name, str(self.Length).encode(),
                  str(self.Offset).encode(), str(self.LineBases).encode(),
                  str(self.LineWidth).encode()]
        if self.QualOffset is not None:
            fields.append(str(self.QualOffset).encode())
        return b"\t".join(fields) + b"\n"


# Zero-copy/owned duality collapses in Python; FaiView aliases FaiRecord for
# API parity with the reference (fai/record.mojo:13-156).
FaiView = FaiRecord
