"""GFF3 record types (reference: blazeseq/_gff/record.mojo)."""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import List, Optional

from ..features.ranges import Interval, Position
from .attributes import Gff3Attributes, parse_gff3_attributes


class Gff3Strand(enum.IntEnum):
    Plus = 0
    Minus = 1
    Unstranded = 2  # '.'
    Unknown = 3  # '?'

    def __str__(self) -> str:
        return {0: "+", 1: "-", 2: ".", 3: "?"}[self.value]


@dataclass(frozen=True)
class SequenceRegion:
    """##sequence-region directive (seqid + 1-based closed interval)."""

    seqid: bytes
    region: Interval


@dataclass(frozen=True)
class TargetAttribute:
    """Structured GFF3 Target attribute: target_id start end [strand]
    (reference: _gff/record.mojo:256-330)."""

    target_id: bytes
    start: int
    end: int
    strand: Optional[Gff3Strand]


def parse_target_attribute(value: bytes) -> TargetAttribute:
    parts = value.split(b" ")
    parts = [p for p in parts if p]
    if len(parts) not in (3, 4):
        raise ValueError("Target: expected 'target_id start end [strand]'")
    start = _parse_uint(parts[1])
    end = _parse_uint(parts[2])
    strand = None
    if len(parts) == 4:
        if parts[3] == b"+":
            strand = Gff3Strand.Plus
        elif parts[3] == b"-":
            strand = Gff3Strand.Minus
        else:
            raise ValueError("Target: strand must be + or -")
    return TargetAttribute(parts[0], start, end, strand)


def _parse_uint(field: bytes) -> int:
    if not field:
        raise ValueError("Target: empty integer field")
    if not field.isdigit():
        raise ValueError("Target: invalid integer digit")
    return int(field)


@dataclass
class Gff3Record:
    """One 9-column GFF3 feature. Coordinates are 1-based closed."""

    Seqid: bytes
    Source: bytes
    Type: bytes
    Start: int
    End: int
    Score: Optional[float]
    Strand_: Optional[Gff3Strand]
    Phase: Optional[int]
    AttributesRaw: bytes
    _attrs: Optional[Gff3Attributes] = None

    def seqid(self) -> str:
        from .attributes import percent_decode

        return percent_decode(self.Seqid).decode("utf-8", "replace")

    def source(self) -> str:
        return self.Source.decode("utf-8", "replace")

    def type(self) -> str:
        return self.Type.decode("utf-8", "replace")

    def strand(self) -> Optional[Gff3Strand]:
        return self.Strand_

    def score(self) -> Optional[float]:
        return self.Score

    def phase(self) -> Optional[int]:
        return self.Phase

    def attributes(self) -> Gff3Attributes:
        if self._attrs is None:
            self._attrs = parse_gff3_attributes(self.AttributesRaw)
        return self._attrs

    def target(self) -> Optional[TargetAttribute]:
        v = self.attributes().get(b"Target")
        return None if v is None else parse_target_attribute(v)

    def interval(self) -> Interval:
        return Interval(Position(self.Start), Position(self.End))

    def __len__(self) -> int:
        return self.End - self.Start + 1

    def to_bytes(self) -> bytes:
        score = b"." if self.Score is None else repr(self.Score).encode()
        strand = b"." if self.Strand_ is None else str(self.Strand_).encode()
        phase = b"." if self.Phase is None else str(self.Phase).encode()
        return b"\t".join([
            self.Seqid, self.Source, self.Type,
            str(self.Start).encode(), str(self.End).encode(),
            score, strand, phase, self.AttributesRaw,
        ]) + b"\n"


Gff3View = Gff3Record
