"""FASTA record type (reference: blazeseq/fasta/record.mojo).

Multi-line sequences are normalized to one contiguous byte string (no embedded
newlines)."""

from __future__ import annotations

from ..fastq.record import Definition, _definition_from_id


class FastaRecord:
    """A single FASTA record: id (without '>') + normalized sequence.
    Hash/equality are on the sequence."""

    __slots__ = ("_id", "_sequence")

    def __init__(self, id, sequence):
        self._id = id.encode() if isinstance(id, str) else bytes(id)
        self._sequence = (
            sequence.encode() if isinstance(sequence, str) else bytes(sequence))

    def id(self) -> str:
        return self._id.decode("utf-8", "replace")

    def sequence(self) -> str:
        return self._sequence.decode("utf-8", "replace")

    def id_bytes(self) -> bytes:
        return self._id

    def sequence_bytes(self) -> bytes:
        return self._sequence

    def definition(self) -> Definition:
        return _definition_from_id(self._id)

    def __len__(self) -> int:
        return len(self._sequence)

    def byte_len(self) -> int:
        """Serialized length '>' + id + '\\n' + sequence + '\\n'
        (reference: fasta/record.mojo byte_len)."""
        return 1 + len(self._id) + 1 + len(self._sequence) + 1

    def to_bytes(self, line_width: int = 60) -> bytes:
        """Standard FASTA serialization with wrapped sequence lines
        (reference: fasta/record.mojo:103-119; width <= 0 disables wrapping)."""
        width = line_width if line_width > 0 else max(len(self._sequence), 1)
        parts = [b">", self._id, b"\n"]
        for i in range(0, len(self._sequence), width):
            parts.append(self._sequence[i : i + width])
            parts.append(b"\n")
        return b"".join(parts)

    def write(self, writer, line_width: int = 60) -> None:
        writer.write_bytes(self.to_bytes(line_width))

    def __hash__(self) -> int:
        return hash(self._sequence)

    def __eq__(self, other) -> bool:
        return isinstance(other, FastaRecord) and self._sequence == other._sequence

    def __repr__(self) -> str:
        return self.to_bytes().decode("utf-8", "replace")
