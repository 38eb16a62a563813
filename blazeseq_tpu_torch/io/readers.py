"""Byte sources (reference: blazeseq/io/readers.mojo).

The reference defines a `Reader` trait with one method
``read_to_buffer(buf, amt, pos) -> n`` (readers.mojo:51-79) and four
implementations: FileReader, MemoryReader, GZFile (zlib FFI), RapidgzipReader
(parallel C++ inflate). Here a Reader is any object with
``readinto(memoryview) -> int`` (0 at EOF) — the Python-native equivalent —
plus ``close()``. Parsers are generic over this protocol, so file, memory,
zlib, and parallel-gzip sources are interchangeable.

The parallel-decompression equivalent of RapidgzipReader (readers.mojo:380-443)
is `ParallelGzipReader`: a pipelined zlib inflater running in background
threads. For BGZF files (bgzip; each block an independent gzip member with the
BC extra field) blocks are decompressed in parallel across a thread pool; for
plain gzip streams, decompression is pipelined one-stream-ahead so inflate
overlaps with parsing (zlib releases the GIL).
"""

from __future__ import annotations

import io
import os
import queue
import struct
import threading
import zlib
from typing import Optional, Protocol, runtime_checkable

from ..constants import MB


@runtime_checkable
class Reader(Protocol):
    def readinto(self, buf: memoryview) -> int: ...  # 0 at EOF
    def close(self) -> None: ...


class FileReader:
    """Plain file byte source (reference: readers.mojo:86-137)."""

    def __init__(self, path):
        self._f = open(path, "rb", buffering=0)

    def readinto(self, buf: memoryview) -> int:
        n = self._f.readinto(buf)
        return n or 0

    def read(self, n: int = -1) -> bytes:
        return self._f.read(n)

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class MmapReader(FileReader):
    """Memory-mapped plain-file byte source: exposes the whole file as one
    zero-copy window (`as_array`), so ByteStream never copies and bulk
    scanners run over the full file at memory speed. Falls back to
    FileReader streaming if the file cannot be mapped (empty file, special
    files, pipes)."""

    def __init__(self, path):
        super().__init__(path)
        self._mm = None
        try:
            import mmap

            self._mm = mmap.mmap(self._f.fileno(), 0,
                                 prot=mmap.PROT_READ)
            try:
                self._mm.madvise(mmap.MADV_SEQUENTIAL)
            except (AttributeError, OSError):
                pass
        except (OSError, ValueError):
            self._mm = None

    def as_array(self):
        if self._mm is None:
            return None
        import numpy as np

        return np.frombuffer(self._mm, dtype=np.uint8)

    def close(self) -> None:
        # the mmap outlives close() intentionally: parser windows may still
        # view it; the mapping is released when the last view is collected
        super().close()


class MemoryReader:
    """In-memory byte source with reset() for benchmark reuse
    (reference: readers.mojo:140-223)."""

    def __init__(self, data):
        self._data = memoryview(bytes(data) if isinstance(data, bytearray) else data)
        self._pos = 0

    def readinto(self, buf: memoryview) -> int:
        n = min(len(buf), len(self._data) - self._pos)
        if n <= 0:
            return 0
        buf[:n] = self._data[self._pos : self._pos + n]
        self._pos += n
        return n

    def as_array(self):
        """Zero-copy numpy view over the remaining bytes. ByteStream adopts
        this directly, skipping the readinto memcpy for in-memory sources."""
        import numpy as np

        return np.frombuffer(self._data, dtype=np.uint8,
                             offset=self._pos)

    def reset(self) -> None:
        self._pos = 0

    def close(self) -> None:
        pass


class GZFile:
    """Single-threaded gzip source via zlib (reference: readers.mojo:283-377).

    Streams through `zlib.decompressobj` with a raw-deflate-over-gzip wrapper
    (wbits=31) and handles multi-member gzip files (e.g. bgzip output).
    """

    def __init__(self, path, read_chunk: int = 1 * MB):
        self._f = open(path, "rb", buffering=0)
        self._dec = zlib.decompressobj(wbits=31)
        self._read_chunk = read_chunk
        self._pending = b""
        self._eof = False

    def _decompress_more(self) -> None:
        while not self._pending and not self._eof:
            if self._dec.eof:
                # multi-member: restart on leftover tail
                tail = self._dec.unused_data
                self._dec = zlib.decompressobj(wbits=31)
                if tail:
                    self._pending = self._dec.decompress(tail)
                    continue
            raw = self._f.read(self._read_chunk)
            if not raw:
                self._eof = True
                self._pending = self._dec.flush()
                break
            self._pending = self._dec.decompress(raw)

    def readinto(self, buf: memoryview) -> int:
        self._decompress_more()
        n = min(len(buf), len(self._pending))
        if n == 0:
            return 0
        buf[:n] = self._pending[:n]
        self._pending = self._pending[n:]
        return n

    def close(self) -> None:
        self._f.close()


class BgzfReader(GZFile):
    """Gzip source positioned at a BGZF *virtual offset*.

    BGZF (bgzip/samtools) files are a series of independent <=64 KiB gzip
    members, so ``voffset = (compressed_block_start << 16) | in_block_offset``
    pinpoints any decompressed byte with one seek + at most one block of
    skipped inflate output — the htslib virtual-offset convention. Seeking
    a block boundary is just a file seek; :class:`GZFile` already restarts
    its decompressor per member, so streaming from there needs no extra
    machinery. Used by the ``.fqi`` index for random access into
    compressed FASTQ (fastq/index.py); random access is an open item
    upstream (reference README.md:129-134, docs/TODO.md:5-8).
    """

    def __init__(self, path, voffset: int = 0, read_chunk: int = 1 * MB):
        super().__init__(path, read_chunk)
        coff, uoff = voffset >> 16, voffset & 0xFFFF
        if coff:
            self._f.seek(coff)
        while uoff:  # drop the in-block prefix from the inflate output
            self._decompress_more()
            if not self._pending:
                raise ValueError(
                    "virtual offset %d points past the decompressed stream"
                    % voffset)
            n = min(uoff, len(self._pending))
            self._pending = self._pending[n:]
            uoff -= n


def scan_bgzf_blocks(path):
    """Header-only pass over a BGZF file -> block table, no decompression.

    Returns ``(coffsets, ustarts, total_u)``: int64 arrays of each
    non-empty block's compressed start offset and decompressed start
    offset, plus the total decompressed size. Reads ~30 bytes per 64 KiB
    block (header + trailing ISIZE), so it runs at effectively seek speed;
    this is what lets ``build_fqi`` turn decompressed checkpoint offsets
    into virtual offsets without a second inflate pass.
    """
    import numpy as np

    coffs, ustarts = [], []
    u = 0
    with open(str(path), "rb") as f:
        coff = 0
        while True:
            header = f.read(18)
            if not header:
                break
            if len(header) < 18 or header[:2] != b"\x1f\x8b":
                raise ValueError("not a BGZF file: %s" % path)
            xlen = struct.unpack("<H", header[10:12])[0]
            extra = header[12:18] + (f.read(xlen - 6) if xlen > 6 else b"")
            bsize = None
            e = extra
            while len(e) >= 4:
                si1, si2, slen = e[0], e[1], struct.unpack("<H", e[2:4])[0]
                if si1 == 66 and si2 == 67 and slen == 2:
                    bsize = struct.unpack("<H", e[4:6])[0]
                e = e[4 + slen:]
            if bsize is None:
                raise ValueError("gzip member without a BC subfield (not "
                                 "BGZF): %s @ %d" % (path, coff))
            f.seek(coff + bsize + 1 - 4)
            isize = struct.unpack("<I", f.read(4))[0]
            if isize:
                coffs.append(coff)
                ustarts.append(u)
                u += isize
            coff += bsize + 1
            f.seek(coff)
    return (np.asarray(coffs, dtype=np.int64),
            np.asarray(ustarts, dtype=np.int64), u)


def _is_bgzf(header: bytes) -> bool:
    """Detect the BGZF variant of gzip (BC extra subfield)."""
    if len(header) < 18 or header[:2] != b"\x1f\x8b" or header[3] & 4 == 0:
        return False
    xlen = struct.unpack("<H", header[10:12])[0]
    extra = header[12 : 12 + xlen]
    while len(extra) >= 4:
        si1, si2, slen = extra[0], extra[1], struct.unpack("<H", extra[2:4])[0]
        if si1 == 66 and si2 == 67 and slen == 2:
            return True
        extra = extra[4 + slen :]
    return False


class _BgzfBlockIter:
    """Iterate (compressed_block_bytes) of a BGZF file using the BSIZE field."""

    def __init__(self, f):
        self._f = f

    def __iter__(self):
        while True:
            header = self._f.read(18)
            if len(header) < 18:
                return
            xlen = struct.unpack("<H", header[10:12])[0]
            extra = self._f.read(xlen - 6) if xlen > 6 else b""
            full_extra = header[12:18] + extra
            bsize = None
            e = full_extra
            while len(e) >= 4:
                si1, si2, slen = e[0], e[1], struct.unpack("<H", e[2:4])[0]
                if si1 == 66 and si2 == 67 and slen == 2:
                    bsize = struct.unpack("<H", e[4:6])[0]
                e = e[4 + slen :]
            if bsize is None:
                raise ValueError("not a BGZF block")
            rest = self._f.read(bsize + 1 - 18 - (xlen - 6) if xlen > 6 else bsize + 1 - 18)
            yield header + extra + rest


class ParallelGzipReader:
    """Parallel/pipelined gzip source (TPU-native stand-in for RapidgzipReader,
    reference: readers.mojo:380-443; pixi.toml:36-46).

    parallelism=0 uses all cores (reference semantics). For BGZF inputs each
    64KB block is an independent deflate stream, decompressed concurrently by a
    worker pool (zlib releases the GIL, so threads scale). For arbitrary gzip
    streams decompression runs in one background thread, overlapping inflate
    with downstream parsing/compute — the critical property for keeping the
    host->HBM feed pipeline saturated.
    """

    def __init__(self, path, parallelism: int = 0, read_chunk: int = 1 * MB):
        if parallelism <= 0:
            parallelism = os.cpu_count() or 1
        self._parallelism = parallelism
        self._path = path
        with open(path, "rb") as probe:
            head = probe.read(64)
        self._bgzf = _is_bgzf(head)
        self._queue: queue.Queue = queue.Queue(maxsize=max(4, 2 * parallelism))
        self._pending = b""
        self._pos = 0
        self._done = False
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    # -- producer side ------------------------------------------------------
    def _produce(self):
        try:
            if self._bgzf and self._parallelism > 1:
                self._produce_bgzf()
            elif ((self._parallelism >= 4
                   and (os.cpu_count() or 1) >= 4
                   or os.environ.get("BLAZESEQ_FORCE_PUGZ") == "1")
                  and self._try_pugz()):
                # parallel marker-inflate is ~0.5x zlib per core: only a win
                # when enough REAL cores back the threads
                pass  # parallel arbitrary-gzip inflate handled everything
            else:
                self._produce_stream()
        except BaseException as e:  # surfaced on the consumer side
            self._err = e
        finally:
            self._queue.put(None)

    def _try_pugz(self) -> bool:
        """Parallel inflate of arbitrary single-stream gzip (pugz/rapidgzip
        design, io/pugz.py). Streams resolved parts into the bounded queue
        (so memory stays ~parallelism x chunk and decompression overlaps
        parsing). Failures BEFORE the first part fall back to the pipelined
        sequential path; later integrity failures raise, exactly like a
        streaming zlib consumer detecting corruption at the trailer.
        Returns True when output was (or is being) produced here."""
        from .pugz import parallel_inflate_stream

        emitted = False
        mm = self._load_compressed()
        try:
            for part in parallel_inflate_stream(mm, self._parallelism):
                if self._stop.is_set():
                    return True
                if part:
                    self._queue.put(part)
                    emitted = True
        except Exception:
            if not emitted:
                return False
            raise
        finally:
            # release the mapping promptly (it can span many GB of address
            # space); numpy views created inside the stream hold their own
            # reference via the buffer protocol
            try:
                mm.close()
            except (BufferError, OSError):
                pass
        return True

    def _load_compressed(self):
        """Memory-map the compressed file: the parallel path needs random
        access to compressed bytes, but paging via mmap keeps RSS bounded
        for arbitrarily large inputs (the OS evicts cold pages)."""
        import mmap

        f = open(self._path, "rb")
        try:
            return mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        finally:
            f.close()

    def _produce_stream(self):
        with open(self._path, "rb", buffering=0) as f:
            dec = zlib.decompressobj(wbits=31)
            while not self._stop.is_set():
                raw = f.read(1 * MB)
                if not raw:
                    out = dec.flush()
                    if out:
                        self._queue.put(out)
                    return
                while raw:
                    out = dec.decompress(raw)
                    if out:
                        self._queue.put(out)
                    if dec.eof:
                        raw = dec.unused_data
                        dec = zlib.decompressobj(wbits=31)
                    else:
                        raw = b""

    def _produce_bgzf(self):
        from concurrent.futures import ThreadPoolExecutor

        def inflate(block: bytes) -> bytes:
            return zlib.decompress(block, wbits=31)

        with open(self._path, "rb", buffering=0) as f, ThreadPoolExecutor(
            max_workers=self._parallelism
        ) as pool:
            in_flight: "queue.Queue" = queue.Queue()
            blocks = iter(_BgzfBlockIter(f))
            depth = 4 * self._parallelism

            def submit_next() -> bool:
                try:
                    blk = next(blocks)
                except StopIteration:
                    return False
                in_flight.put(pool.submit(inflate, blk))
                return True

            for _ in range(depth):
                if not submit_next():
                    break
            while not in_flight.empty():
                if self._stop.is_set():
                    return
                fut = in_flight.get()
                out = fut.result()
                if out:
                    self._queue.put(out)
                submit_next()

    # -- consumer side ------------------------------------------------------
    def readinto(self, buf: memoryview) -> int:
        while self._pos >= len(self._pending):
            if self._done:  # persistent: repeat the error / EOF, never hang
                if self._err is not None:
                    raise self._err
                return 0
            item = self._queue.get()
            if item is None:
                self._done = True
                if self._err is not None:
                    raise self._err
                return 0
            self._pending = item
            self._pos = 0
        n = min(len(buf), len(self._pending) - self._pos)
        buf[:n] = self._pending[self._pos : self._pos + n]
        self._pos += n
        return n

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass


# Back-compat alias mirroring the reference's public name.
RapidgzipReader = ParallelGzipReader


def open_reader(path, parallelism: int = 4) -> Reader:
    """Open a byte source by file suffix (reference suffix dispatch:
    python/blazeseq_parser.mojo:100-114)."""
    p = str(path)
    if p.endswith(".gz") or p.endswith(".bgz"):
        return ParallelGzipReader(p, parallelism=parallelism)
    return MmapReader(p)
