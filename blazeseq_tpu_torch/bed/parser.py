"""Streaming BED parser + writer (reference: blazeseq/_bed/parser.mojo,
_bed/writer.mojo).

TAB rows over the DelimitedReader engine with a BED line policy that skips
blanks, '#' comments, and UCSC `track`/`browser` lines. Accepts >= 3 columns;
BED10/11 extra columns and columns beyond 12 go to other_fields. Reference
error message classes preserved.
"""

from __future__ import annotations

from typing import Iterator, List, Optional

from ..errors import FastxEOFError, ParseError
from ..io.delimited import DefaultLinePolicy, DelimitedReader, LineAction
from .record import BedRecord, BedView, ItemRgb, Strand, parse_comma_sep_int_list

MSG_INT_EMPTY = "BED: integer field is empty"
MSG_INT_INVALID = "BED: invalid byte in integer field"
MSG_STRAND = "BED: strand must be +, -, or ."
MSG_SCORE = "BED: score must be in [0, 1000]"
MSG_RGB_FORMAT = "BED: itemRgb must be 0 or r,g,b"
MSG_RGB_RANGE = "BED: itemRgb components must be 0-255"
MSG_FIELDS = "BED: row must have at least 3 fields"
MSG_BLOCK = "BED: blockCount must be > 0"
MSG_START_END = "BED: chromStart must be <= chromEnd"


class BedLinePolicy(DefaultLinePolicy):
    """Skip blanks, '#' comments, UCSC track/browser lines
    (reference: _bed/parser.mojo:204-247)."""

    def classify(self, line: bytes) -> LineAction:
        if not line:
            return LineAction.SKIP
        if line[0] == 35:  # '#'
            return LineAction.SKIP
        tok = line.split(maxsplit=1)[0] if line.strip() else b""
        if tok in (b"track", b"browser"):
            return LineAction.SKIP
        return LineAction.YIELD


def _parse_uint(field: bytes, ctx) -> int:
    if not field:
        raise ParseError(MSG_INT_EMPTY, *ctx)
    v = 0
    for b in field:
        d = b - 48
        if d < 0 or d > 9:
            raise ParseError(MSG_INT_INVALID, *ctx)
        v = v * 10 + d
    return v


def _parse_strand(field: bytes, ctx) -> Strand:
    if field == b"+":
        return Strand.Plus
    if field == b"-":
        return Strand.Minus
    if field == b".":
        return Strand.Unknown
    raise ParseError(MSG_STRAND, *ctx)


def _parse_score(field: bytes, ctx) -> int:
    v = _parse_uint(field, ctx)
    if v > 1000:
        raise ParseError(MSG_SCORE, *ctx)
    return v


def _parse_item_rgb(field: bytes, ctx) -> ItemRgb:
    """'0' or 'r,g,b' with 0-255 components (reference: _bed/parser.mojo:139-196)."""
    s = field.strip(b" \t\n\r")
    if s == b"0":
        return ItemRgb(0, 0, 0)
    parts = s.split(b",")
    if len(parts) != 3:
        raise ParseError(MSG_RGB_FORMAT, *ctx)
    vals = []
    for p in parts:
        if not p or not p.isdigit():
            raise ParseError(MSG_RGB_FORMAT, *ctx)
        v = int(p)
        if v > 255:
            raise ParseError(MSG_RGB_RANGE, *ctx)
        vals.append(v)
    return ItemRgb(*vals)


class BedParser:
    """Streaming BED parser over a Reader (reference: _bed/parser.mojo:251-420)."""

    def __init__(self, reader):
        self._rows = DelimitedReader(reader, delimiter=b"\t",
                                     policy=BedLinePolicy(), has_header=False)

    def has_more(self) -> bool:
        return self._rows.has_more()

    def _ctx(self):
        return (self._rows._record_number, self._rows.lines.get_line_number(),
                self._rows.lines.get_file_position())

    def next_view(self) -> BedView:
        if not self.has_more():
            raise FastxEOFError()
        view = self._rows.next_view()
        ctx = self._ctx()
        n = view.num_fields()
        if n < 3:
            raise ParseError(MSG_FIELDS, *ctx)
        chrom = view.get_bytes(0)
        chrom_start = _parse_uint(view.get_bytes(1), ctx)
        chrom_end = _parse_uint(view.get_bytes(2), ctx)
        if chrom_start > chrom_end:
            raise ParseError(MSG_START_END, *ctx)
        rec = BedRecord(chrom, chrom_start, chrom_end, num_fields=n)
        if n >= 4:
            rec.Name = view.get_bytes(3)
        if n >= 5:
            rec.Score = _parse_score(view.get_bytes(4), ctx)
        if n >= 6:
            rec.Strand_ = _parse_strand(view.get_bytes(5), ctx)
        if n >= 7:
            rec.ThickStart = _parse_uint(view.get_bytes(6), ctx)
        if n >= 8:
            rec.ThickEnd = _parse_uint(view.get_bytes(7), ctx)
        if n >= 9:
            rec.ItemRgb_ = _parse_item_rgb(view.get_bytes(8), ctx)
        if n >= 12:
            bc = _parse_uint(view.get_bytes(9), ctx)
            if bc < 1:
                raise ParseError(MSG_BLOCK, *ctx)
            rec.BlockCount = bc
            rec.BlockSizes = parse_comma_sep_int_list(view.get_bytes(10))
            rec.BlockStarts = parse_comma_sep_int_list(view.get_bytes(11))
            if n > 12:
                rec.OtherFields = [view.get_bytes(i) for i in range(12, n)]
        elif n > 9:
            rec.OtherFields = [view.get_bytes(i) for i in range(9, n)]
        return rec

    def next_record(self) -> BedRecord:
        return self.next_view()

    def views(self) -> Iterator[BedView]:
        while True:
            try:
                yield self.next_view()
            except FastxEOFError:
                return

    def records(self) -> Iterator[BedRecord]:
        return self.views()

    def __iter__(self) -> Iterator[BedRecord]:
        return self.records()


class BedWriter:
    """Streaming BED writer (reference: _bed/writer.mojo:11-36)."""

    def __init__(self, writer):
        self._writer = writer

    def write_record(self, rec: BedRecord) -> None:
        rec.write(self._writer)

    write_view = write_record
