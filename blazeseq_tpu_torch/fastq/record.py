"""FASTQ record types + standalone Validator
(reference: blazeseq/fastq/record.mojo).

`FastqRecord` is the owned representation (safe to store, reference
record.mojo:230-428); `FastqView` is the zero-copy representation referencing
the parser's window buffer, valid only until the parser reads more data
(record.mojo:431-551). Both expose the same API: id/sequence/quality,
phred_scores, definition, write.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from ..errors import FastxErrorCode, validation_error_from_code
from .quality import GENERIC_SCHEMA, QualitySchema

_POSIX_SPACE = b" \t\n\v\f\r\x1c\x1d\x1e"


def strip_spaces(b: bytes) -> bytes:
    """Trim leading/trailing POSIX whitespace (reference: utils.mojo:223-242)."""
    return b.strip(_POSIX_SPACE)


class Definition(NamedTuple):
    """Id + optional Description split of a header line
    (reference: blazeseq/fasta/definition.mojo:4-18)."""

    Id: bytes
    Description: Optional[bytes]


def _definition_from_id(id_bytes: bytes) -> Definition:
    """First space-separated token vs rest (reference: record.mojo:369-382)."""
    parts = id_bytes.split(b" ")
    head = parts[0].strip(_POSIX_SPACE)
    if len(parts) > 1:
        desc = strip_spaces(b"".join(parts[1:]))
        return Definition(head, desc)
    return Definition(head, None)


class _RecordBase:
    """Shared API surface for FastqRecord / FastqView."""

    __slots__ = ()

    _id: object
    _sequence: object
    _quality: object
    _phred_offset: int

    def id(self) -> str:
        return bytes(self._id).decode("utf-8", "replace")

    def sequence(self) -> str:
        return bytes(self._sequence).decode("utf-8", "replace")

    def quality(self) -> str:
        return bytes(self._quality).decode("utf-8", "replace")

    def id_bytes(self) -> bytes:
        return bytes(self._id)

    def sequence_bytes(self) -> bytes:
        return bytes(self._sequence)

    def quality_bytes(self) -> bytes:
        return bytes(self._quality)

    def phred_scores(self, offset: Optional[int] = None) -> np.ndarray:
        """Decoded Phred scores as uint8 (reference: record.mojo:340-355)."""
        off = self._phred_offset if offset is None else offset
        q = np.frombuffer(bytes(self._quality), dtype=np.uint8)
        return q - np.uint8(off)

    def definition(self) -> Definition:
        return _definition_from_id(bytes(self._id))

    def __len__(self) -> int:
        return len(self._sequence)

    def byte_len(self) -> int:
        """Serialized length: '@' + id + seq + qual + newlines and '+\\n'
        (reference: record.mojo:384-388)."""
        return 1 + len(self._id) + len(self._sequence) + len(self._quality) + 5

    def to_bytes(self) -> bytes:
        """Standard 4-line FASTQ serialization with a bare '+' separator
        (reference: record.mojo:390-402)."""
        return b"@%s\n%s\n+\n%s\n" % (
            bytes(self._id),
            bytes(self._sequence),
            bytes(self._quality),
        )

    def write(self, writer) -> None:
        writer.write_bytes(self.to_bytes())


class _ViewMixin:
    """FastqView conveniences shared by the C-backed and pure-Python
    storage variants."""

    __slots__ = ()

    def to_record(self) -> "FastqRecord":
        return FastqRecord(
            bytes(self._id),
            bytes(self._sequence),
            bytes(self._quality),
            phred_offset=self._phred_offset,
        )

    def __repr__(self) -> str:
        return self.to_bytes().decode("utf-8", "replace")


class _RecordMixin:
    """FastqRecord conveniences shared by the C-backed and pure-Python
    storage variants. Hash/equality are on the sequence only
    (reference: record.mojo:415-423)."""

    __slots__ = ()

    @classmethod
    def from_string(cls, fast_str: str) -> "FastqRecord":
        """Build from one 4-line string; the plus line is discarded
        (reference: record.mojo:293-303)."""
        seqs = fast_str.strip().split("\n")
        if len(seqs) > 4:
            raise ValueError("Sequence does not seem to be valid")
        return cls(seqs[0].strip(), seqs[1].strip(), seqs[3].strip(),
                   phred_offset=33)

    def __hash__(self) -> int:
        return hash(bytes(self._sequence))

    def __eq__(self, other) -> bool:
        return isinstance(other, (_RecordBase, _CBased)) and bytes(
            self._sequence) == bytes(other._sequence)

    def __ne__(self, other) -> bool:
        return not self.__eq__(other)

    def __repr__(self) -> str:
        return self.to_bytes().decode("utf-8", "replace")


def _load_c_bases():
    from .. import native

    return native.records_ext()


_C = _load_c_bases()
_CBased: tuple = ()

if _C is not None:
    # C-native storage (native/records_ext.c): Record is one variable-size
    # object holding all three byte spans (single allocation per record);
    # View is a zero-copy triple of (owner, ptr, len) references. The FULL
    # record/view API lives on the C types themselves (no Python subclass:
    # plain C types allocate without heap-subclass/GC machinery, ~30%
    # faster per object); the three Python-flavored pieces (Definition
    # construction, numpy phred decode, from_string parsing) are
    # registered as helper callables.
    def _phred_helper(qual_bytes: bytes, offset: int):
        q = np.frombuffer(qual_bytes, dtype=np.uint8)
        return q - np.uint8(offset)

    def _from_string_helper(cls, fast_str: str):
        """Build from one 4-line string; the plus line is discarded
        (reference: record.mojo:293-303)."""
        seqs = fast_str.strip().split("\n")
        if len(seqs) > 4:
            raise ValueError("Sequence does not seem to be valid")
        return cls(seqs[0].strip(), seqs[1].strip(), seqs[3].strip(),
                   phred_offset=33)

    _C.set_helpers(_definition_from_id, _phred_helper, _from_string_helper)
    FastqView = _C.View
    FastqRecord = _C.Record
    _CBased = (_C.Record, _C.View)
else:
    class FastqView(_ViewMixin, _RecordBase):  # type: ignore[no-redef]
        """Zero-copy record view into the parser buffer. Invalidated by the
        next parser read; copy with .to_record() to store."""

        __slots__ = ("_id", "_sequence", "_quality", "_phred_offset")

        def __init__(self, id_mv, seq_mv, qual_mv, phred_offset: int = 33):
            self._id = id_mv
            self._sequence = seq_mv
            self._quality = qual_mv
            self._phred_offset = phred_offset

    class FastqRecord(_RecordMixin, _RecordBase):  # type: ignore[no-redef]
        """Owned FASTQ record."""

        __slots__ = ("_id", "_sequence", "_quality", "_phred_offset")

        def __init__(self, id, sequence, quality,
                     schema: QualitySchema | None = None,
                     phred_offset: Optional[int] = None):
            self._id = id.encode() if isinstance(id, str) else bytes(id)
            self._sequence = (
                sequence.encode() if isinstance(sequence, str)
                else bytes(sequence)
            )
            self._quality = (
                quality.encode() if isinstance(quality, str)
                else bytes(quality)
            )
            if phred_offset is not None:
                self._phred_offset = phred_offset
            else:
                self._phred_offset = (schema or GENERIC_SCHEMA).OFFSET


class Validator:
    """Optional ASCII / quality-range validation
    (reference: record.mojo:20-226). Structure (@/+/length) is validated in
    the parser hot loop, not here."""

    def __init__(self, check_ascii: bool, check_quality: bool,
                 quality_schema: QualitySchema):
        self.check_ascii = check_ascii
        self.check_quality = check_quality
        self.quality_schema = quality_schema

    def _validate(self, record: _RecordBase) -> FastxErrorCode:
        if self.check_ascii:
            if not (
                bytes(record._id).isascii()
                and bytes(record._sequence).isascii()
                and bytes(record._quality).isascii()
            ):
                return FastxErrorCode.ASCII_INVALID
        if self.check_quality:
            q = bytes(record._quality)
            if q:
                lo, hi = self.quality_schema.LOWER, self.quality_schema.UPPER
                if min(q) < lo or max(q) > hi:
                    return FastxErrorCode.QUALITY_OUT_OF_RANGE
        return FastxErrorCode.OK

    def validate(self, record: _RecordBase, record_number: int = 0,
                 line_number: int = 0) -> None:
        code = self._validate(record)
        if code != FastxErrorCode.OK:
            raise validation_error_from_code(
                code, record_number, "", self._id_snippet(record)
            )

    @staticmethod
    def _id_snippet(record: _RecordBase) -> str:
        s = bytes(record._id).decode("utf-8", "replace")
        if len(s) > 100:
            s = s[:97] + "..."
        return s
