"""Generic delimited-file (TSV) engine (reference: blazeseq/io/delimited.mojo).

`DelimitedReader` drives a `LinePolicy` that classifies each line
(YIELD/SKIP/METADATA/HEADER/STOP, delimited.mojo:20-77) and yields rows as
`DelimitedView` (borrowing the line buffer) or `DelimitedRecord` (owned).
Field boundaries are computed once per row; a field-count consistency check
raises on ragged rows (delimited.mojo:460-468).

Suitable for quote-free formats: FAI, BED, GFF3, GTF.
"""

from __future__ import annotations

import enum
from typing import Iterator, Optional

from ..constants import DEFAULT_CAPACITY
from ..errors import FastxEOFError, ParseError
from .buffered import LineIterator


class LineAction(enum.IntEnum):
    YIELD = 0
    SKIP = 1
    METADATA = 2
    HEADER = 3
    STOP = 4


class DefaultLinePolicy:
    """Skip blank lines, yield everything else (delimited.mojo:66-77)."""

    def classify(self, line: bytes) -> LineAction:
        if len(line) == 0:
            return LineAction.SKIP
        return LineAction.YIELD


MAX_FIELDS = 64


class _RowBase:
    __slots__ = ("_line", "_bounds", "_delimiter")

    def __init__(self, line, delimiter: bytes):
        self._line = line
        self._delimiter = delimiter
        self._bounds = _fill_offsets(bytes(line), delimiter)

    def num_fields(self) -> int:
        return len(self._bounds)

    def __len__(self) -> int:
        return len(self._bounds)

    def get_span(self, idx: int):
        a, b = self._bounds[idx]
        return self._line[a:b]

    def get_bytes(self, idx: int) -> bytes:
        a, b = self._bounds[idx]
        return bytes(self._line[a:b])

    def get(self, idx: int):
        if idx < 0 or idx >= len(self._bounds):
            return None
        return self.get_span(idx)

    def __getitem__(self, idx: int) -> bytes:
        return self.get_bytes(idx)

    def to_bytes(self) -> bytes:
        return self._delimiter.join(
            self.get_bytes(i) for i in range(len(self._bounds)))

    def __repr__(self) -> str:
        return self.to_bytes().decode("utf-8", "replace")


def _fill_offsets(line: bytes, delimiter: bytes):
    """Field (start, end) pairs; trailing delimiter appends one empty field
    (reference: delimited.mojo:121-143). Capped at MAX_FIELDS."""
    bounds = []
    n = len(line)
    start = 0
    d = delimiter[0]
    while start <= n and len(bounds) < MAX_FIELDS:
        idx = line.find(d, start)
        end = idx if idx != -1 else n
        bounds.append((start, end))
        if idx == -1:
            break
        start = idx + 1
    if n > 0 and line[n - 1] == d and len(bounds) < MAX_FIELDS:
        bounds.append((n, n))
    return bounds


class DelimitedView(_RowBase):
    """Borrowing row view; invalidated by the next reader advance
    (delimited.mojo:151-211)."""

    def to_record(self) -> "DelimitedRecord":
        return DelimitedRecord(bytes(self._line), self._delimiter)


class DelimitedRecord(_RowBase):
    """Owned row (delimited.mojo:219-274)."""


class DelimitedReader:
    """Generic delimited reader over a Reader (delimited.mojo:276-468)."""

    def __init__(self, reader, delimiter: bytes = b"\t",
                 policy=None, has_header: bool = False,
                 capacity: int = DEFAULT_CAPACITY,
                 check_consistent_fields: bool = True):
        self.lines = LineIterator(reader, capacity=capacity,
                                  growth_enabled=True)
        self._delimiter = delimiter
        self._record_number = 0
        self._has_header = has_header
        self._header: Optional[DelimitedRecord] = None
        self._check_consistent = check_consistent_fields
        self._expected_num_fields = 0
        self.policy = policy or DefaultLinePolicy()
        self._stopped = False
        if has_header and self.lines.has_more():
            line = self._next_data_line()
            self._parse_header_from(line)

    def has_more(self) -> bool:
        return not self._stopped and self.lines.has_more()

    def header(self) -> Optional[DelimitedRecord]:
        return self._header

    def handle_metadata(self, line) -> None:
        """Hook for subclass/format-specific metadata lines."""

    def _next_data_line(self):
        while True:
            line = self.lines.next_line()  # raises FastxEOFError at EOF
            action = self.policy.classify(bytes(line))
            if action == LineAction.YIELD:
                return line
            if action == LineAction.SKIP:
                continue
            if action == LineAction.METADATA:
                self.handle_metadata(bytes(line))
                continue
            if action == LineAction.HEADER:
                self._parse_header_from(line)
                continue
            self._stopped = True
            raise FastxEOFError()

    def _parse_header_from(self, line) -> None:
        view = DelimitedView(line, self._delimiter)
        self._expected_num_fields = view.num_fields()
        self._header = view.to_record()

    def _check_field_count(self, n: int) -> None:
        if not self._check_consistent:
            return
        if self._expected_num_fields == 0:
            self._expected_num_fields = n
        elif n != self._expected_num_fields:
            raise ParseError(
                "Delimited row has inconsistent number of fields",
                record_number=self._record_number,
                line_number=self.lines.get_line_number(),
                file_position=self.lines.get_file_position(),
            )

    def next_view(self) -> DelimitedView:
        if not self.has_more():
            raise FastxEOFError()
        line = self._next_data_line()
        view = DelimitedView(line, self._delimiter)
        self._check_field_count(view.num_fields())
        self._record_number += 1
        return view

    def next_record(self) -> DelimitedRecord:
        return self.next_view().to_record()

    def views(self) -> Iterator[DelimitedView]:
        while True:
            try:
                yield self.next_view()
            except FastxEOFError:
                return

    def records(self) -> Iterator[DelimitedRecord]:
        while True:
            try:
                yield self.next_record()
            except FastxEOFError:
                return

    def __iter__(self) -> Iterator[DelimitedView]:
        return self.views()
