"""Buffered streaming window + line iteration (reference: blazeseq/io/buffered.mojo).

Design departure from the reference: instead of a fixed-capacity buffer with a
resumable SIMD scan state machine (BufferedReader + `_scan_record` SearchPhase,
buffered.mojo:115-327 / utils.mojo:472-551), the TPU-native host path is
*chunk-vectorized*: `ByteStream` maintains a window of unconsumed bytes in a
preallocated numpy buffer, and consumers scan whole windows at once with bulk
newline discovery (native C++ SIMD or numpy), yielding thousands of
line/record offsets per Python-level call. Per-byte work never happens in
Python.

Zero-copy views handed to callers are memoryviews/array views into the window
buffer. As in the reference (record.mojo:435-441), they are invalidated by the
next refill/compaction: stale views may observe new bytes but never crash.

Capacity semantics are preserved for API parity: when a single line/record
exceeds `capacity` and growth is disabled, the same "exceeds buffer capacity"
errors are raised (reference: buffered.mojo:740-764, errors.mojo:242-270).
"""

from __future__ import annotations

import numpy as np

from ..constants import DEFAULT_CAPACITY, DEFAULT_CHUNK_SIZE, MAX_CAPACITY, NEW_LINE
from ..errors import FastxEOFError, ParseError, buffer_capacity_error


class ByteStream:
    """Window of unconsumed bytes over a Reader, in a preallocated buffer.

    `consume()` advances a head pointer; compaction (memmove-equivalent of
    BufferedReader._compact_from, buffered.mojo:25-56) or growth happens on
    `fill()` when space runs out. `last_shift` reports how far absolute
    offsets moved during the most recent fill so offset caches can re-anchor.
    """

    __slots__ = ("_reader", "_arr", "_head", "_end", "_eof", "_consumed",
                 "chunk_size", "last_shift")

    def __init__(self, reader, chunk_size: int = DEFAULT_CHUNK_SIZE):
        self._reader = reader
        self._head = 0
        self._eof = False
        self._consumed = 0  # total bytes consumed from stream start
        self.chunk_size = chunk_size
        self.last_shift = 0
        as_array = getattr(reader, "as_array", None)
        arr = as_array() if as_array is not None else None
        if arr is not None:
            # zero-copy window over an in-memory/mmap source: the whole
            # stream is already addressable, so fill() is a no-op and no
            # compaction or copying ever happens
            self._arr = arr
            self._end = len(self._arr)
            self._eof = True
        else:
            self._arr = np.empty(2 * chunk_size, dtype=np.uint8)
            self._end = 0

    def available(self) -> int:
        return self._end - self._head

    def is_eof(self) -> bool:
        return self._eof

    def has_more(self) -> bool:
        return self.available() > 0 or not self._eof

    def stream_position(self) -> int:
        """Byte offset in the decompressed stream of the next unconsumed byte
        (reference: BufferedReader.stream_position)."""
        return self._consumed

    def fill(self) -> int:
        """Read one more chunk into the window; returns bytes added (0 at EOF).
        May compact (shifting absolute offsets left by `last_shift`) or grow
        the underlying buffer."""
        self.last_shift = 0
        if self._eof:
            return 0
        free = len(self._arr) - self._end
        if free < self.chunk_size:
            if self._head > 0 and self._head + free >= self.chunk_size:
                # compact: move [head, end) to 0
                n = self.available()
                self._arr[:n] = self._arr[self._head : self._end]
                self.last_shift = self._head
                self._head = 0
                self._end = n
            else:
                # grow: double the buffer
                new = np.empty(max(2 * len(self._arr), self._end + self.chunk_size),
                               dtype=np.uint8)
                new[: self._end] = self._arr[: self._end]
                self._arr = new
        mv = memoryview(self._arr.data)[self._end : self._end + self.chunk_size]
        n = self._reader.readinto(mv)
        if n == 0:
            self._eof = True
        else:
            self._end += n
        return n

    def window(self) -> np.ndarray:
        """The full buffer up to _end (offsets are absolute in this view)."""
        return self._arr[: self._end]

    def mview(self) -> memoryview:
        return memoryview(self._arr.data)[: self._end]

    def consume(self, n: int) -> None:
        self._head += n
        self._consumed += n

    def close(self) -> None:
        self._reader.close()


class LineIteratorError(Exception):
    """Typed non-raising-path errors of LineIterator
    (reference: blazeseq/io/buffered.mojo:61-99). `code` is one of the
    class attributes EOF / EMPTY_BUFFER / INCOMPLETE_LINE / OTHER."""

    EOF = "EOF"
    EMPTY_BUFFER = "EMPTY_BUFFER"
    INCOMPLETE_LINE = "INCOMPLETE_LINE"
    OTHER = "OTHER"

    def __init__(self, code: str):
        super().__init__(code)
        self.code = code


class LineIterator:
    """Newline-delimited line iterator with bulk scanning
    (reference: blazeseq/io/buffered.mojo:507-823).

    `next_line()` yields memoryviews excluding the '\\n' and trimming one
    trailing '\\r' (buffered.mojo:511-518); the final unterminated line is
    yielded at EOF; FastxEOFError("EOF") is raised when exhausted. Newline
    positions are discovered in bulk per window using numpy and served from a
    cursor, so the per-line Python cost is O(1)."""

    def __init__(
        self,
        reader,
        capacity: int = DEFAULT_CAPACITY,
        growth_enabled: bool = False,
        max_capacity: int = MAX_CAPACITY,
        chunk_size: int | None = None,
    ):
        self._stream = ByteStream(reader, chunk_size or min(capacity, DEFAULT_CHUNK_SIZE))
        self._capacity = capacity
        self._growth_enabled = growth_enabled
        self._max_capacity = max_capacity
        self._line_number = 0
        self._file_position = 0
        # bulk newline cache: absolute positions within the current buffer
        self._nl: list = []
        self._nl_cursor = 0
        self._scanned_upto = 0  # absolute buffer offset scanned so far
        if self._stream._end > 0:  # zero-copy in-memory source: scan upfront
            self._scan_new()

    # -- bookkeeping ---------------------------------------------------------
    def get_line_number(self) -> int:
        return self._line_number

    def get_file_position(self) -> int:
        return self._file_position

    def stream_position(self) -> int:
        return self._stream.stream_position()

    def has_more(self) -> bool:
        return self._stream.has_more()

    # -- internals -----------------------------------------------------------
    def _scan_new(self) -> None:
        """Discover newlines in the not-yet-scanned region of the buffer."""
        s = self._stream
        arr = s._arr[self._scanned_upto : s._end]
        new_pos = np.flatnonzero(arr == NEW_LINE)
        if self._nl_cursor:
            self._nl = self._nl[self._nl_cursor :]
            self._nl_cursor = 0
        if len(new_pos):
            self._nl.extend((new_pos + self._scanned_upto).tolist())
        self._scanned_upto = s._end

    def _fill(self) -> int:
        s = self._stream
        n = s.fill()
        if s.last_shift:
            shift = s.last_shift
            self._nl = [p - shift for p in self._nl[self._nl_cursor :]]
            self._nl_cursor = 0
            self._scanned_upto = max(self._scanned_upto - shift, 0)
        if n:
            self._scan_new()
        return n

    # -- public --------------------------------------------------------------
    def next_line(self) -> memoryview:
        """Next line excluding '\\n', trailing '\\r' trimmed. Raises
        FastxEOFError at end of stream."""
        s = self._stream
        while True:
            self._file_position = s.stream_position()
            if self._nl_cursor < len(self._nl):
                nl = self._nl[self._nl_cursor]
                self._nl_cursor += 1
                start = s._head
                end = nl
                if end > start and s._arr[end - 1] == 13:  # \r
                    end -= 1
                line = memoryview(s._arr.data)[start:end]
                s.consume(nl + 1 - start)
                self._line_number += 1
                return line
            # no complete line in window
            if s.is_eof():
                if s.available() == 0:
                    raise FastxEOFError()
                # final unterminated line
                start = s._head
                end = s._end
                if end > start and s._arr[end - 1] == 13:
                    end -= 1
                line = memoryview(s._arr.data)[start:end]
                s.consume(s._end - start)
                self._line_number += 1
                return line
            if s.available() >= self._capacity:
                if not self._growth_enabled:
                    raise ParseError(
                        buffer_capacity_error(self._capacity, growth_hint=True)
                    )
                if s.available() >= self._max_capacity:
                    raise ParseError(
                        buffer_capacity_error(
                            self._capacity, self._max_capacity, True, at_max=True
                        )
                    )
            if self._fill() == 0 and s.available() == 0:
                raise FastxEOFError()

    def next_complete_line(self) -> memoryview:
        """Return the next line only if a complete line (ending with '\\n')
        is already in the buffer; refill once only to distinguish EOF from an
        empty buffer (reference: buffered.mojo:641-678). Raises
        LineIteratorError with code EOF / EMPTY_BUFFER / INCOMPLETE_LINE.
        Callers fall back to next_line() to force a refill."""
        s = self._stream
        self._file_position = s.stream_position()
        if s.available() == 0:
            if s.is_eof():
                raise LineIteratorError(LineIteratorError.EOF)
            try:
                self._fill()
            except Exception:
                raise LineIteratorError(LineIteratorError.OTHER)
            if s.available() == 0:
                if s.is_eof():
                    raise LineIteratorError(LineIteratorError.EOF)
                raise LineIteratorError(LineIteratorError.EMPTY_BUFFER)
        if self._nl_cursor < len(self._nl):
            nl = self._nl[self._nl_cursor]
            self._nl_cursor += 1
            start = s._head
            end = nl
            if end > start and s._arr[end - 1] == 13:
                end -= 1
            line = memoryview(s._arr.data)[start:end]
            s.consume(nl + 1 - start)
            self._line_number += 1
            return line
        if s.is_eof():
            # final unterminated line
            start = s._head
            end = s._end
            if end > start and s._arr[end - 1] == 13:
                end -= 1
            line = memoryview(s._arr.data)[start:end]
            s.consume(s._end - start)
            self._line_number += 1
            return line
        raise LineIteratorError(LineIteratorError.INCOMPLETE_LINE)

    def _check_span_capacity(self, size: int) -> None:
        """Enforce the same capacity/growth contract as next_line for APIs
        that must hold `size` contiguous bytes in the buffer."""
        if size > self._capacity and not self._growth_enabled:
            raise ParseError(
                buffer_capacity_error(self._capacity, growth_hint=True))
        if size > self._max_capacity:
            raise ParseError(
                buffer_capacity_error(self._capacity, self._max_capacity,
                                      True, at_max=True))

    def peek(self, amt: int) -> memoryview:
        """The next `amt` buffered bytes without consuming
        (reference: buffered.mojo:682-686)."""
        self._check_span_capacity(amt)
        s = self._stream
        while s.available() < amt:
            if s.is_eof() or self._fill() == 0:
                raise FastxEOFError()
        return memoryview(s._arr.data)[s._head : s._head + amt]

    def read_exact(self, size: int) -> memoryview:
        """Read exactly `size` bytes, refilling as needed; FastxEOFError if
        the stream ends short (reference: buffered.mojo:688-705). The view is
        valid until the next mutating call."""
        self._check_span_capacity(size)
        s = self._stream
        self._file_position = s.stream_position()
        while s.available() < size:
            if s.is_eof():
                raise FastxEOFError()
            if self._fill() == 0 and s.available() < size:
                raise FastxEOFError()
        start = s._head
        out = memoryview(s._arr.data)[start : start + size]
        s.consume(size)
        # newline bookkeeping: drop cached newline positions now consumed
        while (self._nl_cursor < len(self._nl)
               and self._nl[self._nl_cursor] < s._head):
            self._nl_cursor += 1
            self._line_number += 1
        return out

    def __iter__(self):
        return self

    def __next__(self) -> memoryview:
        try:
            return self.next_line()
        except FastxEOFError:
            raise StopIteration
