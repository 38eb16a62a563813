"""Streaming GTF2.2 parser (reference: blazeseq/_gtf/parser.mojo,
_gtf/record.mojo).

9-column TAB rows, '#' comment lines skipped; strand +/-/., phase 0-2;
mandatory gene_id/transcript_id enforced in next_record when strict."""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Iterator, Optional

from ..errors import FastxEOFError, ParseError
from ..features.ranges import Interval, Position
from ..io.delimited import DefaultLinePolicy, DelimitedReader, LineAction
from .attributes import GtfAttributes, parse_gtf_attributes

MSG_INT_EMPTY = "GTF: integer field is empty"
MSG_INT_INVALID = "GTF: invalid byte in integer field"
MSG_STRAND = "GTF: strand must be +, -, or ."
MSG_PHASE = "GTF: phase must be 0, 1, or 2"
MSG_FIELDS = "GTF: row must have exactly 9 fields"
MSG_COORD_ZERO = "GTF: start/end coordinate must be >= 1 (1-based)"
MSG_START_END = "GTF: start must be <= end"
MSG_NO_GENE_ID = "GTF: gene_id attribute is missing (required by GTF2.2)"
MSG_NO_TRANSCRIPT_ID = (
    "GTF: transcript_id attribute is missing (required by GTF2.2)")


class GtfStrand(enum.IntEnum):
    Plus = 0
    Minus = 1
    Unknown = 2

    def __str__(self) -> str:
        return {0: "+", 1: "-", 2: "."}[self.value]


@dataclass
class GtfRecord:
    Seqname: bytes
    Source: bytes
    Feature: bytes
    Start: int
    End: int
    Score: Optional[float]
    Strand_: Optional[GtfStrand]
    Frame: Optional[int]
    AttributesRaw: bytes
    _attrs: Optional[GtfAttributes] = None

    @property
    def Attributes(self) -> GtfAttributes:
        if self._attrs is None:
            self._attrs = parse_gtf_attributes(self.AttributesRaw)
        return self._attrs

    def attributes(self) -> GtfAttributes:
        return self.Attributes

    def seqname(self) -> str:
        return self.Seqname.decode("utf-8", "replace")

    def feature(self) -> str:
        return self.Feature.decode("utf-8", "replace")

    def interval(self) -> Interval:
        return Interval(Position(self.Start), Position(self.End))

    def __len__(self) -> int:
        return self.End - self.Start + 1

    def to_bytes(self) -> bytes:
        score = b"." if self.Score is None else repr(self.Score).encode()
        strand = b"." if self.Strand_ is None else str(self.Strand_).encode()
        frame = b"." if self.Frame is None else str(self.Frame).encode()
        return b"\t".join([
            self.Seqname, self.Source, self.Feature,
            str(self.Start).encode(), str(self.End).encode(),
            score, strand, frame, self.AttributesRaw]) + b"\n"


GtfView = GtfRecord


class GtfLinePolicy(DefaultLinePolicy):
    """Blank lines and '#' comments skipped (reference: _gtf/parser.mojo:92-101)."""

    def classify(self, line: bytes) -> LineAction:
        if not line:
            return LineAction.SKIP
        if line[0] == 35:
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


class GtfParser:
    """Streaming GTF parser over a Reader (reference: _gtf/parser.mojo:105-275)."""

    def __init__(self, reader, strict_mandatory_attrs: bool = True):
        self._rows = DelimitedReader(reader, delimiter=b"\t",
                                     policy=GtfLinePolicy(), has_header=False,
                                     check_consistent_fields=False)
        self._strict = strict_mandatory_attrs

    def has_more(self) -> bool:
        return self._rows.has_more()

    def _ctx(self):
        return (self._rows._record_number, self._rows.lines.get_line_number(),
                self._rows.lines.get_file_position())

    def next_view(self) -> GtfView:
        if not self.has_more():
            raise FastxEOFError()
        view = self._rows.next_view()
        ctx = self._ctx()
        if view.num_fields() != 9:
            raise ParseError(MSG_FIELDS, *ctx)
        start = _parse_uint(view.get_bytes(3), ctx)
        if start == 0:
            raise ParseError(MSG_COORD_ZERO, *ctx)
        end = _parse_uint(view.get_bytes(4), ctx)
        if end == 0:
            raise ParseError(MSG_COORD_ZERO, *ctx)
        if start > end:
            raise ParseError(MSG_START_END, *ctx)
        score_b = view.get_bytes(5)
        if score_b in (b"", b"."):
            score = None
        else:
            try:
                score = float(score_b)
            except ValueError:
                raise ParseError("GTF: invalid score", *ctx)
        strand_b = view.get_bytes(6)
        if strand_b == b"+":
            strand: Optional[GtfStrand] = GtfStrand.Plus
        elif strand_b == b"-":
            strand = GtfStrand.Minus
        elif strand_b == b".":
            strand = GtfStrand.Unknown
        elif strand_b == b"":
            strand = None
        else:
            raise ParseError(MSG_STRAND, *ctx)
        frame_b = view.get_bytes(7)
        if frame_b in (b"", b"."):
            frame = None
        else:
            fv = _parse_uint(frame_b, ctx)
            if fv > 2:
                raise ParseError(MSG_PHASE, *ctx)
            frame = fv
        return GtfRecord(
            Seqname=view.get_bytes(0), Source=view.get_bytes(1),
            Feature=view.get_bytes(2), Start=start, End=end, Score=score,
            Strand_=strand, Frame=frame, AttributesRaw=view.get_bytes(8))

    def next_record(self) -> GtfRecord:
        rec = self.next_view()
        if self._strict:
            if not rec.Attributes.gene_id:
                raise ParseError(MSG_NO_GENE_ID)
            if not rec.Attributes.transcript_id:
                raise ParseError(MSG_NO_TRANSCRIPT_ID)
        return rec

    def views(self) -> Iterator[GtfView]:
        while True:
            try:
                yield self.next_view()
            except FastxEOFError:
                return

    def records(self) -> Iterator[GtfRecord]:
        while True:
            try:
                yield self.next_record()
            except FastxEOFError:
                return

    def __iter__(self) -> Iterator[GtfRecord]:
        return self.records()
