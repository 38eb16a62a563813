"""Streaming FASTA parser — chunk-vectorized host engine
(behavior spec: blazeseq/fasta/parser.mojo).

Like the FASTQ parser, whole buffered windows are scanned at once by the
native bulk kernel (bs_scan_fasta), which normalizes multi-line sequences into
contiguous byte arrays with cumulative end offsets. The Python layer serves
records from those arrays (O(1) per record) and reproduces the reference's
edge semantics:

* every line is POSIX-whitespace-stripped at both ends (parser.mojo:138-148)
* blank lines before a header are skipped; a non-'>' first line raises
  "FASTA: sequence id line does not start with '>'" (parser.mojo:189-192)
* an empty sequence raises "FASTA record has empty sequence" (parser.mojo:152-159)
* EOF is FastxEOFError("EOF"); iterators stop cleanly.

A batch mode (`next_batch`) returns the SoA arrays directly for device
materialization (survey §7.2 step 5: FASTA sequence payloads as device tensors).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from .. import native
from ..constants import DEFAULT_BATCH_SIZE, TPU_LANE
from ..errors import (
    FastxEOFError,
    FastxErrorCode,
    ParseError,
    validation_error_from_code,
)
from ..io.buffered import ByteStream
from .record import FastaRecord


@dataclass
class FastaParserConfig:
    """Reference: fasta/parser.mojo:23-33."""

    check_ascii: bool = False


class FastaBatch:
    """SoA batch of FASTA records: concatenated sequence bytes + cumulative
    ends; ids host-side. Converts to padded device tensors."""

    __slots__ = ("ids", "id_ends", "seq", "seq_ends")

    def __init__(self, ids, id_ends, seq, seq_ends):
        self.ids = ids
        self.id_ends = id_ends
        self.seq = seq
        self.seq_ends = seq_ends

    def __len__(self) -> int:
        return len(self.seq_ends)

    def get_record(self, i: int) -> FastaRecord:
        a = int(self.id_ends[i - 1]) if i else 0
        b = int(self.id_ends[i])
        c = int(self.seq_ends[i - 1]) if i else 0
        d = int(self.seq_ends[i])
        return FastaRecord(self.ids[a:b].tobytes(), self.seq[c:d].tobytes())

    def to_records(self):
        return [self.get_record(i) for i in range(len(self))]

    def lengths(self) -> np.ndarray:
        return np.diff(self.seq_ends, prepend=0)

    def to_padded(self, max_len: Optional[int] = None):
        """Padded [n, L] uint8 sequence tensor + lengths (device layout).

        With max_len, L is EXACTLY max_len rounded up to the TPU lane —
        a static shape across batches (one XLA compilation) — and longer
        sequences are clamped (lengths report the clamped value)."""
        n = len(self)
        lens = self.lengths()
        if max_len is not None:
            L = max_len
        else:
            L = int(lens.max()) if n else 0
        L = max(((L + TPU_LANE - 1) // TPU_LANE) * TPU_LANE, TPU_LANE)
        out = np.zeros((n, L), dtype=np.uint8)
        if n:
            starts = np.concatenate([[0], self.seq_ends[:-1]])
            flat = np.arange(len(self.seq), dtype=np.int64)
            rec = np.searchsorted(self.seq_ends, flat, side="right")
            keep = (flat - starts[rec]) < L
            out[rec[keep], (flat - starts[rec])[keep]] = self.seq[keep]
        return out, np.minimum(lens, L).astype(np.int32)


class FastaParser:
    """Streaming FASTA parser over a Reader (reference: fasta/parser.mojo:59-198)."""

    def __init__(self, reader, config: Optional[FastaParserConfig] = None,
                 chunk_size: Optional[int] = None):
        self.config = config or FastaParserConfig()
        self._stream = ByteStream(reader, chunk_size or 1024 * 1024)
        self._record_number = 0  # completed records
        self._line_number = 0  # lines consumed
        # queue of scanned records
        self._ids = np.empty(0, dtype=np.uint8)
        self._id_ends = np.empty(0, dtype=np.int64)
        self._seqs = np.empty(0, dtype=np.uint8)
        self._seq_ends = np.empty(0, dtype=np.int64)
        self._q_pos = 0

    def has_more(self) -> bool:
        return self._q_pos < len(self._id_ends) or self._stream.has_more()

    def _queue_len(self) -> int:
        return len(self._id_ends) - self._q_pos

    def _scan_more(self) -> None:
        s = self._stream
        if s.available() == 0:
            s.fill()
        if not s.has_more():
            raise FastxEOFError()
        while True:
            res = native.scan_fasta(
                s.window(), start=s._head, at_eof=s.is_eof(),
                check_ascii=self.config.check_ascii)
            if len(res.id_ends) or res.err_code:
                self._ingest(res)
                return
            if s.is_eof():
                # nothing but blanks remained
                s.consume(s.available())
                raise FastxEOFError()
            if s.fill() == 0 and s.available() == 0:
                raise FastxEOFError()

    def _ingest(self, res) -> None:
        s = self._stream
        self._ids = res.ids
        self._id_ends = res.id_ends
        self._seqs = res.seqs
        self._seq_ends = res.seq_ends
        self._q_pos = 0
        consumed_rel = res.consumed - s._head
        self._pending_err = None
        if res.err_code:
            self._pending_err = (res.err_code,
                                 self._line_number + res.err_line + 1)
        s.consume(consumed_rel)
        self._line_number += res.lines_consumed
        if res.err_code and len(res.id_ends) == 0:
            self._raise_pending()

    _pending_err = None

    def _raise_pending(self):
        code, line = self._pending_err
        self._pending_err = None
        if code == 100:
            raise ParseError(
                "FASTA: sequence id line does not start with '>'",
                record_number=self._record_number,
                line_number=line - 1 if line > 0 else 0,
                file_position=self._stream.stream_position(),
            )
        if code == 101:
            raise ParseError(
                "FASTA record has empty sequence",
                record_number=self._record_number + 1,
                line_number=line,
                file_position=self._stream.stream_position(),
            )
        raise validation_error_from_code(
            FastxErrorCode.ASCII_INVALID, self._record_number + 1)

    def next_record(self) -> FastaRecord:
        if not self.has_more():
            raise FastxEOFError()
        if self._q_pos >= len(self._id_ends):
            if self._pending_err:
                self._raise_pending()
            try:
                self._scan_more()
            except FastxEOFError:
                if self._pending_err:
                    self._raise_pending()
                raise
        i = self._q_pos
        a = int(self._id_ends[i - 1]) if i else 0
        b = int(self._id_ends[i])
        c = int(self._seq_ends[i - 1]) if i else 0
        d = int(self._seq_ends[i])
        self._q_pos += 1
        self._record_number += 1
        return FastaRecord(self._ids[a:b].tobytes(), self._seqs[c:d].tobytes())

    def records(self) -> Iterator[FastaRecord]:
        """Bulk-drain iterator: one bytes copy of the scanned id/seq arenas
        per scan, then C-level slicing + __new__ per record (the per-record
        Python work of next_record dominates otherwise)."""
        new = FastaRecord.__new__
        while True:
            if self._q_pos >= len(self._id_ends):
                if self._pending_err:
                    self._raise_pending()
                try:
                    self._scan_more()
                except FastxEOFError:
                    if self._pending_err:
                        self._raise_pending()
                    return
            qid = self._id_ends
            ids = self._ids.tobytes()
            seqs = self._seqs.tobytes()
            id_ends = qid.tolist()
            seq_ends = self._seq_ends.tolist()
            qlen = len(id_ends)
            # cursor read fresh per iteration + queue-identity check: safe
            # under interleaved next_record/next_batch calls
            while self._q_pos < qlen and self._id_ends is qid:
                i = self._q_pos
                a = id_ends[i - 1] if i else 0
                c = seq_ends[i - 1] if i else 0
                self._q_pos = i + 1
                self._record_number += 1
                r = new(FastaRecord)
                r._id = ids[a : id_ends[i]]
                r._sequence = seqs[c : seq_ends[i]]
                yield r

    def __iter__(self) -> Iterator[FastaRecord]:
        return self.records()

    def next_batch(self, max_records: int = DEFAULT_BATCH_SIZE) -> FastaBatch:
        """SoA batch of up to max_records (device materialization path)."""
        ids_parts, seq_parts = [], []
        id_ends_parts, seq_ends_parts = [], []
        got = 0
        id_base = seq_base = 0
        while got < max_records:
            if self._q_pos >= len(self._id_ends):
                try:
                    self._scan_more()
                except FastxEOFError:
                    break
            take = min(max_records - got, self._queue_len())
            i0, i1 = self._q_pos, self._q_pos + take
            a = int(self._id_ends[i0 - 1]) if i0 else 0
            c = int(self._seq_ends[i0 - 1]) if i0 else 0
            b = int(self._id_ends[i1 - 1])
            d = int(self._seq_ends[i1 - 1])
            ids_parts.append(self._ids[a:b])
            seq_parts.append(self._seqs[c:d])
            id_ends_parts.append(self._id_ends[i0:i1] - a + id_base)
            seq_ends_parts.append(self._seq_ends[i0:i1] - c + seq_base)
            id_base += b - a
            seq_base += d - c
            self._q_pos = i1
            self._record_number += take
            got += take
        if not ids_parts:
            return FastaBatch(np.empty(0, np.uint8), np.empty(0, np.int64),
                              np.empty(0, np.uint8), np.empty(0, np.int64))
        return FastaBatch(
            np.concatenate(ids_parts), np.concatenate(id_ends_parts),
            np.concatenate(seq_parts), np.concatenate(seq_ends_parts))

    def batches(self, max_records: int = DEFAULT_BATCH_SIZE):
        while self.has_more():
            b = self.next_batch(max_records)
            if len(b) == 0:
                return
            yield b

    def padded_batches(self, max_records: int = DEFAULT_BATCH_SIZE,
                       max_len: Optional[int] = None):
        """Stream padded device-layout sequence batches: yields
        (seq u8[n, L], lengths i32[n]) per batch — the FASTA device
        materialization feed (SURVEY §7.2 step 5). Sequences longer than
        max_len are clamped (lengths report the clamped value)."""
        for b in self.batches(max_records):
            yield b.to_padded(max_len=max_len)

    def count(self):
        """(records, bases) at scan speed.

        Fast path: the counting kernel (native.count_fasta) tallies records
        and non-whitespace sequence bytes in one vector pass with no
        materialization. Whenever it cannot prove its accounting equals the
        parser's (pathological whitespace, empty sequences, content before
        a header), the exact scan path takes over for that window — so
        counts and raised errors are always identical to records()."""
        records = 0
        bases = 0
        s = self._stream
        while True:
            if self._q_pos < len(self._id_ends):
                i0 = self._q_pos
                c = int(self._seq_ends[i0 - 1]) if i0 else 0
                records += self._queue_len()
                bases += int(self._seq_ends[-1]) - c
                self._record_number += self._queue_len()
                self._q_pos = len(self._id_ends)
            if (not self.config.check_ascii and s.available() > 0):
                fast = native.count_fasta(s.window(), start=s._head,
                                          at_eof=s.is_eof())
                if fast is not None:
                    r, b, consumed, lines = fast
                    if consumed > s._head:
                        s.consume(consumed - s._head)
                        records += r
                        bases += b
                        self._record_number += r
                        self._line_number += lines
                        if s.available() == 0 and not s.has_more():
                            break
                        if s.available() > 0 and not s.is_eof():
                            s.fill()
                        continue
                    if s.is_eof() and consumed >= len(s.window()):
                        break
                # fast path unavailable or made no progress: exact path
            try:
                self._scan_more()
            except FastxEOFError:
                break
        return records, bases
