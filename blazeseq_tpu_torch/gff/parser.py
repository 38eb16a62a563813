"""Streaming GFF3 parser (reference: blazeseq/_gff/parser.mojo).

9-column TAB rows; directives: ##gff-version validated as 3.x,
##sequence-region collected (sequence_regions()), ### forward-reference
no-op, ##FASTA terminates iteration; single-# comments skipped. Reference
error message classes preserved.
"""

from __future__ import annotations

from typing import Iterator, List, Optional

from ..errors import FastxEOFError, ParseError
from ..features.ranges import Interval, Position
from ..io.delimited import DefaultLinePolicy, DelimitedReader, LineAction
from .attributes import percent_decode
from .record import Gff3Record, Gff3Strand, Gff3View, SequenceRegion

MSG_VERSION = "GFF3: ##gff-version must be 3.x"
MSG_SEQ_REGION = "GFF3: malformed ##sequence-region directive"
MSG_INT_EMPTY = "GFF3: integer field is empty"
MSG_INT_INVALID = "GFF3: invalid byte in integer field"
MSG_STRAND = "GFF3: strand must be +, -, ., or ?"
MSG_PHASE = "GFF3: phase must be 0, 1, or 2"
MSG_FIELDS = "GFF3: row must have exactly 9 fields"
MSG_COORD_ZERO = "GFF3: start/end coordinate must be >= 1 (1-based)"
MSG_START_END = "GFF3: start must be <= end"
MSG_CDS_PHASE = "GFF3: CDS feature requires phase (0, 1, or 2)"

_STRANDS = {b"+": Gff3Strand.Plus, b"-": Gff3Strand.Minus,
            b".": Gff3Strand.Unstranded, b"?": Gff3Strand.Unknown}


class Gff3LinePolicy(DefaultLinePolicy):
    """Blank/# skip; ## -> METADATA; ### -> METADATA no-op; ##FASTA -> STOP
    (reference: _gff/parser.mojo:189-217)."""

    def classify(self, line: bytes) -> LineAction:
        if not line:
            return LineAction.SKIP
        if line.startswith(b"##"):
            if line.startswith(b"###"):
                return LineAction.METADATA
            if line.startswith(b"##FASTA"):
                return LineAction.STOP
            return LineAction.METADATA
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


def _check_gff_version(line: bytes, ctx) -> None:
    """Accept 3 / 3.x; reject empty, 2, '31' (reference: parser.mojo:103-136)."""
    tok = line[13:].strip(b" \t\r\n").split(b" ")[0].split(b"\t")[0]
    if not tok or tok[0:1] != b"3":
        raise ParseError(MSG_VERSION, *ctx)
    if len(tok) >= 2 and tok[1:2] != b".":
        raise ParseError(MSG_VERSION, *ctx)


def _parse_sequence_region(line: bytes, ctx) -> SequenceRegion:
    """Strict single-space tokenization '##sequence-region seqid start end'
    (reference: _gff/parser.mojo:139-186 — extra separating whitespace is an
    error, e.g. AGAT gff_syntax fixture 12)."""
    if len(line) <= 18:
        raise ParseError(MSG_SEQ_REGION, *ctx)
    rest = line[18:]
    i = rest.find(b" ")
    if i == 0:
        raise ParseError("GFF3: ##sequence-region missing seqid", *ctx)
    if i < 0:
        i = len(rest)
    seqid = percent_decode(rest[:i])
    rest2 = rest[i + 1 :]
    j = rest2.find(b" ")
    if j < 0:
        j = len(rest2)
    start = _parse_uint(rest2[:j], ctx)
    end_tok = rest2[j + 1 :].rstrip(b"\n\r ")
    end = _parse_uint(end_tok, ctx)
    return SequenceRegion(seqid, Interval(Position(start), Position(end)))


class Gff3Parser:
    """Streaming GFF3 parser over a Reader (reference: _gff/parser.mojo:355-440)."""

    def __init__(self, reader):
        self._rows = DelimitedReader(reader, delimiter=b"\t",
                                     policy=Gff3LinePolicy(), has_header=False,
                                     check_consistent_fields=False)
        self._seq_regions: List[SequenceRegion] = []
        self._rows.handle_metadata = self._handle_metadata

    def sequence_regions(self) -> List[SequenceRegion]:
        return list(self._seq_regions)

    def has_more(self) -> bool:
        return self._rows.has_more()

    def _ctx(self):
        return (self._rows._record_number, self._rows.lines.get_line_number(),
                self._rows.lines.get_file_position())

    def _handle_metadata(self, line: bytes) -> None:
        ctx = self._ctx()
        if line.startswith(b"###"):
            return  # forward-reference flush: no-op for a streaming parser
        if line.startswith(b"##gff-version"):
            _check_gff_version(line, ctx)
        elif line.startswith(b"##sequence-region"):
            self._seq_regions.append(_parse_sequence_region(line, ctx))

    def next_view(self) -> Gff3View:
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
        score: Optional[float]
        if score_b in (b"", b"."):
            score = None
        else:
            try:
                score = float(score_b)
            except ValueError:
                raise ParseError("GFF3: invalid score", *ctx)
        strand_b = view.get_bytes(6)
        if strand_b in (b"",):
            strand = None
        elif strand_b in _STRANDS:
            strand = _STRANDS[strand_b]
        else:
            raise ParseError(MSG_STRAND, *ctx)
        phase_b = view.get_bytes(7)
        if phase_b in (b"", b"."):
            phase = None
        else:
            pv = _parse_uint(phase_b, ctx)
            if pv > 2:
                raise ParseError(MSG_PHASE, *ctx)
            phase = pv
        ftype = view.get_bytes(2)
        if ftype == b"CDS" and phase is None:
            raise ParseError(MSG_CDS_PHASE, *ctx)
        return Gff3Record(
            Seqid=view.get_bytes(0), Source=view.get_bytes(1), Type=ftype,
            Start=start, End=end, Score=score, Strand_=strand, Phase=phase,
            AttributesRaw=view.get_bytes(8))

    def next_record(self) -> Gff3Record:
        return self.next_view()

    def views(self) -> Iterator[Gff3View]:
        while True:
            try:
                yield self.next_view()
            except FastxEOFError:
                return

    def records(self) -> Iterator[Gff3Record]:
        return self.views()

    def __iter__(self) -> Iterator[Gff3Record]:
        return self.records()
