"""Byte sinks (reference: blazeseq/io/writers.mojo, blazeseq/io/buffered.mojo:330-506).

The reference WriterBackend trait has one method
``write_from_buffer(span, amt, pos)`` (writers.mojo:13-41); here a writer is any
object with ``write(bytes-like) -> int`` and ``close()``. `BufferedWriter`
accumulates into a bytearray and auto-flushes on overflow, flushes on close and
on context-manager exit (destructor-flush analog, buffered.mojo:475-482).
"""

from __future__ import annotations

import zlib

from ..constants import DEFAULT_CAPACITY


class FileWriter:
    def __init__(self, path):
        self._f = open(path, "wb", buffering=0)

    def write(self, data) -> int:
        return self._f.write(data)

    def close(self) -> None:
        self._f.close()


class MemoryWriter:
    def __init__(self):
        self._buf = bytearray()

    def write(self, data) -> int:
        self._buf += data
        return len(data)

    def getvalue(self) -> bytes:
        return bytes(self._buf)

    def close(self) -> None:
        pass


class GZWriter:
    """Gzip sink (reference: writers.mojo:159-225)."""

    def __init__(self, path, level: int = 6):
        self._f = open(path, "wb", buffering=0)
        self._comp = zlib.compressobj(level, zlib.DEFLATED, 31)
        self._closed = False

    def write(self, data) -> int:
        out = self._comp.compress(bytes(data))
        if out:
            self._f.write(out)
        return len(data)

    def close(self) -> None:
        if not self._closed:
            self._f.write(self._comp.flush())
            self._f.close()
            self._closed = True


class BGZFWriter:
    """BGZF sink: bgzip/samtools-compatible blocked gzip. Each <=64KB block
    is an independent gzip member carrying the BC extra subfield with the
    block's compressed size, so readers (including this package's
    ParallelGzipReader block pool) can decompress blocks concurrently and
    index them. A 28-byte EOF marker block terminates the file, as bgzip
    emits. Goes beyond the reference (plain GZWriter only) to make outputs
    parallel-readable."""

    _EOF = bytes.fromhex(
        "1f8b08040000000000ff0600424302001b0003000000000000000000")
    _MAX = 65280  # uncompressed bytes per block (bgzip convention)

    def __init__(self, path, level: int = 6):
        self._f = open(path, "wb", buffering=0)
        self._level = level
        self._buf = bytearray()
        self._closed = False

    def write(self, data) -> int:
        self._buf += bytes(data)
        while len(self._buf) >= self._MAX:
            self._emit_block(bytes(self._buf[: self._MAX]))
            del self._buf[: self._MAX]
        return len(data)

    def _emit_block(self, payload: bytes) -> None:
        comp = zlib.compressobj(self._level, zlib.DEFLATED, -15)
        deflated = comp.compress(payload) + comp.flush()
        bsize = len(deflated) + 25 + 1  # header(12+6) + deflate + crc + isize
        if bsize > 65536:
            # incompressible payload: bisect (cannot happen for <=64KB at
            # level>=1 in practice, but stay safe)
            half = len(payload) // 2
            self._emit_block(payload[:half])
            self._emit_block(payload[half:])
            return
        import struct as _struct

        header = (b"\x1f\x8b\x08\x04" + b"\x00" * 6
                  + _struct.pack("<HBBHH", 6, 66, 67, 2, bsize - 1))
        trailer = _struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF,
                               len(payload) & 0xFFFFFFFF)
        self._f.write(header + deflated + trailer)

    def close(self) -> None:
        if not self._closed:
            if self._buf:
                self._emit_block(bytes(self._buf))
                self._buf.clear()
            self._f.write(self._EOF)
            self._f.close()
            self._closed = True


class BufferedWriter:
    """Buffered sink with auto-flush on full (reference: buffered.mojo:330-506)."""

    def __init__(self, backend, capacity: int = DEFAULT_CAPACITY):
        self._backend = backend
        self._capacity = capacity
        self._buf = bytearray()

    def write_bytes(self, data) -> None:
        self._buf += data
        if len(self._buf) >= self._capacity:
            self.flush()

    def write(self, *parts) -> None:
        for p in parts:
            if isinstance(p, str):
                p = p.encode()
            self.write_bytes(p)

    def flush(self) -> None:
        if self._buf:
            self._backend.write(self._buf)
            self._buf.clear()

    def close(self) -> None:
        self.flush()
        self._backend.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def buffered_writer_for_file(path, capacity: int = DEFAULT_CAPACITY) -> BufferedWriter:
    return BufferedWriter(FileWriter(path), capacity)


def buffered_writer_for_memory(capacity: int = DEFAULT_CAPACITY) -> BufferedWriter:
    return BufferedWriter(MemoryWriter(), capacity)


def buffered_writer_for_gzip(path, capacity: int = DEFAULT_CAPACITY) -> BufferedWriter:
    return BufferedWriter(GZWriter(path), capacity)
