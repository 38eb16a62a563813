"""Typed error model for blazeseq_tpu.

Mirrors the reference error surface (blazeseq/errors.mojo:33-351): an integer
error-code enum used on the no-raise hot path, a `ParseContext` carrying
record/line/byte position, and `ParseError` / `ValidationError` exceptions whose
string form includes the same contextual lines ("Record number", "Line number",
"File position", "Field", "Record snippet") so error-class assertions are
portable across both implementations.

End-of-stream is signalled with `FastxEOFError`, whose ``str()`` is exactly
"EOF" (reference sentinel: blazeseq/CONSTS.mojo:19, blazeseq/io/buffered.mojo:103-112).
"""

from __future__ import annotations

import enum

EOF = "EOF"


class FastxErrorCode(enum.IntEnum):
    """Trivial error codes for hot-path returns (reference: errors.mojo:33-68)."""

    OK = 0
    # Parse structure
    ID_NO_AT = 1
    SEP_NO_PLUS = 2
    SEQ_QUAL_LEN_MISMATCH = 3
    # Validation
    ASCII_INVALID = 4
    QUALITY_OUT_OF_RANGE = 5
    # Refill / EOF
    EOF = 6
    UNEXPECTED_EOF = 7
    BUFFER_EXCEEDED = 8
    BUFFER_AT_MAX = 9
    OTHER = 10

    def message(self) -> str:
        return _MESSAGES.get(self, "Parse or validation error")


_MESSAGES = {
    FastxErrorCode.ID_NO_AT: "Sequence id line does not start with '@'",
    FastxErrorCode.SEP_NO_PLUS: "Separator line does not start with '+'",
    FastxErrorCode.SEQ_QUAL_LEN_MISMATCH: (
        "Quality and sequence line do not match in length"
    ),
    FastxErrorCode.ASCII_INVALID: "Non ASCII letters found",
    FastxErrorCode.QUALITY_OUT_OF_RANGE: (
        "Corrupt quality score according to provided schema"
    ),
    FastxErrorCode.UNEXPECTED_EOF: "Unexpected end of file in FASTQ record",
    FastxErrorCode.BUFFER_EXCEEDED: "FASTQ record exceeds buffer capacity",
    FastxErrorCode.BUFFER_AT_MAX: "FASTQ record exceeds maximum buffer capacity",
}


class ParseContext:
    """Parser position context (reference: errors.mojo:17-25)."""

    __slots__ = ("record_number", "line_number", "file_position")

    def __init__(self, record_number: int, line_number: int, file_position: int):
        self.record_number = record_number
        self.line_number = line_number
        self.file_position = file_position


class FastxError(Exception):
    """Base class for all blazeseq_tpu errors."""


class FastxEOFError(FastxError):
    """End of stream sentinel; str() is exactly "EOF"."""

    def __init__(self):
        super().__init__(EOF)


class ParseError(FastxError):
    """Structural parse error with context (reference: errors.mojo:145-192)."""

    def __init__(
        self,
        message: str,
        record_number: int = 0,
        line_number: int = 0,
        file_position: int = 0,
        record_snippet: str = "",
        code: FastxErrorCode = FastxErrorCode.OTHER,
    ):
        self.message = message
        self.record_number = record_number
        self.line_number = line_number
        self.file_position = file_position
        self.record_snippet = record_snippet
        self.code = code
        super().__init__(self._format())

    def _format(self) -> str:
        parts = [self.message]
        if self.record_number > 0:
            parts.append("\n  Record number: %d" % self.record_number)
        if self.line_number > 0:
            parts.append("\n  Line number: %d" % self.line_number)
        if self.file_position > 0:
            parts.append("\n  File position: %d" % self.file_position)
        if self.record_snippet:
            parts.append("\n  Record snippet: %s" % self.record_snippet)
        return "".join(parts)


class ValidationError(FastxError):
    """Record validation error with context (reference: errors.mojo:195-234)."""

    def __init__(
        self,
        message: str,
        record_number: int = 0,
        field: str = "",
        record_snippet: str = "",
        code: FastxErrorCode = FastxErrorCode.OTHER,
    ):
        self.message = message
        self.record_number = record_number
        self.field = field
        self.record_snippet = record_snippet
        self.code = code
        super().__init__(self._format())

    def _format(self) -> str:
        parts = [self.message]
        if self.record_number > 0:
            parts.append("\n  Record number: %d" % self.record_number)
        if self.field:
            parts.append("\n  Field: %s" % self.field)
        if self.record_snippet:
            parts.append("\n  Record snippet: %s" % self.record_snippet)
        return "".join(parts)


def validation_error_from_code(
    code: FastxErrorCode,
    record_number: int,
    field: str = "",
    record_snippet: str = "",
) -> ValidationError:
    """Build a ValidationError with default field names per code
    (reference: errors.mojo:119-142)."""
    if not field and code == FastxErrorCode.ASCII_INVALID:
        field = "ascii"
    elif not field and code == FastxErrorCode.QUALITY_OUT_OF_RANGE:
        field = "quality"
    return ValidationError(
        code.message(),
        record_number=record_number,
        field=field,
        record_snippet=record_snippet,
        code=code,
    )


def buffer_capacity_error(
    capacity: int,
    max_capacity: int = 0,
    growth_hint: bool = False,
    at_max: bool = False,
) -> str:
    """Shared "line exceeds buffer" message (reference: errors.mojo:242-270)."""
    if at_max and max_capacity > 0:
        msg = "Line exceeds max buffer capacity of %d bytes" % max_capacity
    else:
        msg = "Line exceeds buffer capacity of %d bytes" % capacity
    if growth_hint:
        msg += ". Enable buffer_growth or use a larger buffer_capacity."
    return msg
