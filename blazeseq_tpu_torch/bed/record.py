"""BED record types (reference: blazeseq/_bed/record.mojo).

BED uses 0-based half-open [chromStart, chromEnd); standard fields chrom,
chromStart, chromEnd + optional name, score, strand, thickStart, thickEnd,
itemRgb, blockCount, blockSizes, blockStarts. Extra columns go to
other_fields."""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional

from ..features.ranges import Interval, Position


class Strand(enum.IntEnum):
    """Plus (+), Minus (-), Unknown (.). Absent field (BED5-) is represented
    as None at the record level, distinct from an explicit '.'
    (reference: _bed/record.mojo:24-54)."""

    Plus = 0
    Minus = 1
    Unknown = 2

    def __str__(self) -> str:
        return {0: "+", 1: "-", 2: "."}[self.value]


@dataclass(frozen=True)
class ItemRgb:
    """BED itemRgb: black (0) or r,g,b each 0-255 (record.mojo:57-80)."""

    r: int
    g: int
    b: int

    def is_black(self) -> bool:
        return self.r == 0 and self.g == 0 and self.b == 0

    def __str__(self) -> str:
        return "%d,%d,%d" % (self.r, self.g, self.b)


def parse_comma_sep_int_list(data: bytes) -> List[int]:
    """blockSizes/blockStarts comma lists; tolerant of a trailing comma
    (reference: _bed/record.mojo:278-292)."""
    return [int(part) for part in data.split(b",") if part]


@dataclass
class BedRecord:
    Chrom: bytes
    ChromStart: int
    ChromEnd: int
    Name: Optional[bytes] = None
    Score: Optional[int] = None
    Strand_: Optional[Strand] = None
    ThickStart: Optional[int] = None
    ThickEnd: Optional[int] = None
    ItemRgb_: Optional[ItemRgb] = None
    BlockCount: Optional[int] = None
    BlockSizes: Optional[List[int]] = None
    BlockStarts: Optional[List[int]] = None
    OtherFields: Optional[List[bytes]] = None
    num_fields: int = 3

    # -- accessors -------------------------------------------------------------
    def chrom(self) -> str:
        return self.Chrom.decode("utf-8", "replace")

    def name(self) -> Optional[str]:
        return None if self.Name is None else self.Name.decode("utf-8", "replace")

    def score(self) -> Optional[int]:
        return self.Score

    def strand(self) -> Optional[Strand]:
        return self.Strand_

    def item_rgb(self) -> Optional[ItemRgb]:
        return self.ItemRgb_

    def block_sizes(self) -> Optional[List[int]]:
        return self.BlockSizes

    def block_starts(self) -> Optional[List[int]]:
        return self.BlockStarts

    def other_fields(self) -> Optional[List[bytes]]:
        return self.OtherFields

    def __len__(self) -> int:
        return self.ChromEnd - self.ChromStart

    # -- coordinates (reference: record.mojo:171-193) ---------------------------
    def start_position(self) -> Position:
        """1-based start (BED chromStart -> start+1)."""
        return Position(self.ChromStart + 1)

    def end_position(self) -> Optional[Position]:
        if self.ChromEnd == 0:
            return None
        return Position(self.ChromEnd)

    def interval(self) -> Optional[Interval]:
        """1-based closed [chromStart+1, chromEnd]; None for zero-length."""
        if self.ChromEnd == 0:
            return None
        return Interval(Position(self.ChromStart + 1), Position(self.ChromEnd))

    # -- serialization -----------------------------------------------------------
    def to_bytes(self) -> bytes:
        """One TAB-delimited line with the original column count
        (reference: record.mojo:405-...)."""
        fields: List[bytes] = [
            self.Chrom, str(self.ChromStart).encode(),
            str(self.ChromEnd).encode(),
        ]
        if self.num_fields >= 4:
            fields.append(self.Name if self.Name is not None else b"")
        if self.num_fields >= 5:
            fields.append(str(self.Score if self.Score is not None else 0).encode())
        if self.num_fields >= 6:
            fields.append(str(self.Strand_ if self.Strand_ is not None
                              else Strand.Unknown).encode())
        if self.num_fields >= 7:
            fields.append(str(self.ThickStart or 0).encode())
        if self.num_fields >= 8:
            fields.append(str(self.ThickEnd or 0).encode())
        if self.num_fields >= 9:
            rgb = self.ItemRgb_
            fields.append(b"0" if rgb is None or rgb.is_black()
                          else str(rgb).encode())
        if self.num_fields >= 12 and self.BlockCount is not None:
            fields.append(str(self.BlockCount).encode())
            fields.append(",".join(map(str, self.BlockSizes or [])).encode())
            fields.append(",".join(map(str, self.BlockStarts or [])).encode())
        if self.OtherFields:
            fields.extend(self.OtherFields)
        return b"\t".join(fields) + b"\n"

    def write(self, writer) -> None:
        writer.write_bytes(self.to_bytes())


# View/record duality collapses in Python (parity alias).
BedView = BedRecord
