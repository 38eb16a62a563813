"""Parser + builder for samtools .fai index files
(reference: blazeseq/fai/parser.mojo).

5-column FASTA / 6-column FASTQ TAB rows over the DelimitedReader engine, with
the reference's error classes ("FAI: integer field is empty", "FAI: invalid
byte in integer field", "FAI: row must have 5 or 6 TAB-delimited columns").

`build_fai` additionally generates an index from a FASTA stream (the
capability the ecosystem gets from `samtools faidx`), enabling the
index-vs-faidx verification config in BASELINE.json.
"""

from __future__ import annotations

from typing import Iterator, List, Optional

from ..errors import FastxEOFError, ParseError
from ..io.delimited import DelimitedReader
from .record import FaiRecord, FaiView

_MSG_EMPTY = "FAI: integer field is empty"
_MSG_INVALID = "FAI: invalid byte in integer field"
_MSG_FIELDS = "FAI: row must have 5 or 6 TAB-delimited columns"


def _parse_int(field: bytes, ctx_args) -> int:
    if len(field) == 0:
        raise ParseError(_MSG_EMPTY, *ctx_args)
    value = 0
    for b in field:
        d = b - 48
        if d < 0 or d > 9:
            raise ParseError(_MSG_INVALID, *ctx_args)
        value = value * 10 + d
    return value


class FaiParser:
    """Streaming .fai parser over a Reader (reference: fai/parser.mojo:85-207)."""

    def __init__(self, reader):
        self._rows = DelimitedReader(reader, delimiter=b"\t", has_header=False)

    def has_more(self) -> bool:
        return self._rows.has_more()

    def _ctx_args(self):
        return (self._rows._record_number, self._rows.lines.get_line_number(),
                self._rows.lines.get_file_position())

    def next_view(self) -> FaiView:
        if not self.has_more():
            raise FastxEOFError()
        ctx = self._ctx_args()
        view = self._rows.next_view()
        n = view.num_fields()
        if n != 5 and n != 6:
            raise ParseError(_MSG_FIELDS, *ctx)
        length = _parse_int(view.get_bytes(1), ctx)
        offset = _parse_int(view.get_bytes(2), ctx)
        line_bases = _parse_int(view.get_bytes(3), ctx)
        line_width = _parse_int(view.get_bytes(4), ctx)
        qual_offset: Optional[int] = None
        if n == 6:
            qual_offset = _parse_int(view.get_bytes(5), ctx)
        return FaiRecord(view.get_bytes(0), length, offset, line_bases,
                         line_width, qual_offset)

    def next_record(self) -> FaiRecord:
        return self.next_view()

    def collect(self) -> List[FaiRecord]:
        return list(self.records())

    def views(self) -> Iterator[FaiView]:
        while True:
            try:
                yield self.next_view()
            except FastxEOFError:
                return

    def records(self) -> Iterator[FaiRecord]:
        return self.views()

    def __iter__(self) -> Iterator[FaiRecord]:
        return self.records()


def build_fai(reader, chunk_size: int = 1024 * 1024) -> List[FaiRecord]:
    """Build a FASTA .fai index from raw bytes — samtools-faidx-compatible
    offsets (NAME, LENGTH, byte OFFSET of first base, LINEBASES, LINEWIDTH).

    Requires uniform line widths per contig (as faidx does); raises ParseError
    on ragged sequence lines (other than the final one of a contig).
    """
    from ..io.buffered import ByteStream

    s = ByteStream(reader, chunk_size)
    records: List[FaiRecord] = []
    name = None
    offset = 0  # stream offset of first base of current contig
    length = 0
    line_bases = 0
    line_width = 0
    first_line = True
    pending_short = False  # a shorter line is only legal as a contig's last
    line_no = 0

    def finish():
        nonlocal name
        if name is not None:
            records.append(FaiRecord(name, length, offset,
                                     line_bases or 0, line_width or 0))
            name = None

    pos_in_stream = 0
    carry = b""
    while True:
        if s.fill() == 0 and s.available() == 0:
            break
        data = bytes(s.mview()[s._head:])
        s.consume(len(data))
        data = carry + data
        lines = data.split(b"\n")
        carry = lines.pop()  # last element: partial line (or b"")
        for raw in lines:
            line_no += 1
            nbytes = len(raw) + 1  # incl. newline
            line = raw[:-1] if raw.endswith(b"\r") else raw
            if line.startswith(b">"):
                finish()
                name = line[1:].strip().split(b" ")[0].split(b"\t")[0]
                offset = pos_in_stream + nbytes
                length = 0
                line_bases = 0
                line_width = 0
                first_line = True
                pending_short = False
            elif name is not None and line:
                if first_line:
                    line_bases = len(line)
                    line_width = nbytes
                    first_line = False
                elif pending_short or len(line) > line_bases:
                    raise ParseError(
                        "FAI build: ragged sequence line lengths",
                        line_number=line_no)
                elif len(line) < line_bases:
                    pending_short = True
                length += len(line)
            pos_in_stream += nbytes
    if carry:
        line_no += 1
        line = carry[:-1] if carry.endswith(b"\r") else carry
        if line.startswith(b">"):
            finish()
            name = line[1:].strip().split(b" ")[0]
            length = 0
        elif name is not None and line:
            if first_line:
                line_bases = len(line)
                line_width = len(carry) + 1
            length += len(line)
    finish()
    return records


def write_fai(records: List[FaiRecord], writer) -> None:
    for r in records:
        writer.write_bytes(r.to_bytes())


class IndexedFasta:
    """Random access to a FASTA file through its .fai index — the
    ecosystem's (samtools faidx) answer to the reference's "no random seek"
    limitation (reference README.md:133; the reference parses/builds .fai
    but stops short of fetch).

    Coordinates are 0-based half-open ([start, end), python-slice style).
    """

    def __init__(self, path, fai_path=None):
        import os

        self._path = str(path)
        fai_path = str(fai_path) if fai_path else self._path + ".fai"
        if os.path.exists(fai_path):
            from ..io.readers import FileReader

            self._index = {r.Name: r
                           for r in FaiParser(FileReader(fai_path)).collect()}
        else:
            from ..io.readers import FileReader

            self._index = {r.Name: r
                           for r in build_fai(FileReader(self._path))}
        self._f = open(self._path, "rb")

    def names(self):
        return [n.decode("utf-8", "replace") for n in self._index]

    def length(self, name) -> int:
        return self._record(name).Length

    def _record(self, name) -> FaiRecord:
        key = name.encode() if isinstance(name, str) else bytes(name)
        try:
            return self._index[key]
        except KeyError:
            raise KeyError("sequence %r not in index" % (name,))

    def fetch(self, name, start: int = 0, end: int = None) -> bytes:
        """Sequence bytes for [start, end) of `name` (newlines removed)."""
        rec = self._record(name)
        if end is None or end > rec.Length:
            end = rec.Length
        start = max(0, start)
        if start >= end:
            return b""
        lb, lw = rec.LineBases, rec.LineWidth
        # byte offset of base `start`: full lines before it + remainder
        first = rec.Offset + (start // lb) * lw + (start % lb)
        last = rec.Offset + ((end - 1) // lb) * lw + ((end - 1) % lb)
        self._f.seek(first)
        raw = self._f.read(last - first + 1)
        # strip line terminators (LineWidth - LineBases bytes per wrap)
        return bytes(raw.translate(None, b"\r\n"))

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
