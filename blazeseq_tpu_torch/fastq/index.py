"""FASTQ record index (``.fqi``): random access and exact record-aligned
sharding for plain FASTQ files.

The reference leaves FASTQ random access explicitly open (README.md:129-134,
docs/TODO.md:5-8 — "end-to-end, no seek"); this module closes it the same
way ``.fai`` does for FASTA: a sidecar index built in one scan-speed pass,
then O(1) seeks to any record.

The index stores the absolute byte offset of every ``stride``-th record's
``@`` byte plus total record/base counts. ``IndexedFastq.fetch(start, n)``
seeks to the nearest checkpoint and skips at most ``stride - 1`` records
with the zero-copy view iterator; ``shard_ranges(k)`` cuts the file into
``k`` byte ranges that all begin exactly on a record boundary — the exact
alternative to the speculative byte-split + rescan used when no index
exists (parallel/pipeline.py file sharding).

Compressed FASTQ is indexable too, when it is BGZF (bgzip/samtools blocked
gzip — what ``io/writers.BGZFWriter`` emits): checkpoints are stored as
htslib-style *virtual offsets* ``(compressed_block_start << 16) |
in_block_offset``, resolved by a header-only block scan
(``io/readers.scan_bgzf_blocks`` — ~30 bytes read per 64 KiB block, no
second inflate pass), and ``fetch`` seeks with ``io/readers.BgzfReader``.
Arbitrary single-stream gzip remains unindexable by construction (one
deflate window spans the whole file); ``build_fqi`` says so and names the
recompression path.

File format (text, one value per line, ``.fai``-spirit transparency;
``bgzf=1`` appears in the header when offsets are virtual)::

    #blazeseq-fqi\tv1\tstride=S\trecords=N\tbases=B\tbytes=Z[\tbgzf=1]
    <offset of record 0>
    <offset of record S>
    ...
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..errors import ParseError
from .parser import FastqParser
from .record import FastqRecord

FQI_MAGIC = "#blazeseq-fqi"
DEFAULT_STRIDE = 10_000


@dataclass
class FastqIndex:
    """Checkpoint table over a FASTQ file (see module docstring)."""

    stride: int
    n_records: int
    n_bases: int
    n_bytes: int  # indexed file size (compressed size for BGZF); staleness
    offsets: np.ndarray  # int64 [ceil(n_records / stride)]
    bgzf: bool = False  # offsets are BGZF virtual offsets

    def checkpoint_for(self, record_index: int) -> tuple:
        """(byte offset, records to skip) to reach ``record_index``."""
        if not 0 <= record_index < self.n_records:
            raise IndexError(
                "record %d out of range (0..%d)"
                % (record_index, self.n_records - 1))
        k = record_index // self.stride
        return int(self.offsets[k]), record_index - k * self.stride


def build_fqi(path, stride: int = DEFAULT_STRIDE,
              config=None) -> FastqIndex:
    """One scan-speed pass over a plain FASTQ file -> FastqIndex.

    Validation follows ``config`` (default ParserConfig: structure checks
    only), so a file that indexes cleanly will also parse cleanly under the
    same config.
    """
    if stride < 1:
        raise ValueError("stride must be >= 1")
    p = str(path)
    blocks = None
    if p.endswith(".gz"):
        from ..io.readers import (ParallelGzipReader, _is_bgzf,
                                  scan_bgzf_blocks)

        with open(p, "rb") as f:
            head = f.read(18 + 64)
        if not _is_bgzf(head):
            raise ParseError(
                "cannot build a .fqi over a single-stream gzip file: one "
                "deflate window spans the whole file, so no offset into it "
                "is seekable. Recompress as BGZF (blazeseq_tpu.BGZFWriter) "
                "— then virtual-offset indexing applies — or index the "
                "uncompressed file.")
        blocks = scan_bgzf_blocks(p)
        reader = ParallelGzipReader(p)
    else:
        from ..io.readers import MmapReader

        reader = MmapReader(p)
    parser = FastqParser(reader, config=config)
    checkpoints: List[np.ndarray] = []
    n_records = 0
    n_bases = 0
    for first, starts, seq_lens in parser.offset_chunks():
        n = len(starts)
        # global indices first..first+n-1; keep those divisible by stride
        k0 = -(-first // stride)  # first checkpoint index in this batch
        sel = k0 * stride - first
        if sel < n:
            checkpoints.append(starts[sel::stride])
        n_records += n
        n_bases += int(seq_lens.sum())
    offsets = (np.concatenate(checkpoints) if checkpoints
               else np.empty(0, dtype=np.int64)).astype(np.int64)
    if blocks is not None:
        # decompressed record offsets -> BGZF virtual offsets: the block
        # whose decompressed span contains each checkpoint, then the
        # in-block remainder (always < 2**16 by the BGZF block-size bound)
        blocks_c, blocks_u, total_u = blocks
        if offsets.size and (offsets[-1] >= total_u or len(blocks_u) == 0):
            raise ParseError("BGZF block table disagrees with the "
                             "decompressed stream length (corrupt file?)")
        k = np.searchsorted(blocks_u, offsets, side="right") - 1
        offsets = (blocks_c[k] << 16) | (offsets - blocks_u[k])
    return FastqIndex(stride=stride, n_records=n_records, n_bases=n_bases,
                      n_bytes=os.path.getsize(p), offsets=offsets,
                      bgzf=blocks is not None)


def write_fqi(index: FastqIndex, path) -> None:
    """Serialize (text format, see module docstring)."""
    with open(str(path), "w") as f:
        f.write("%s\tv1\tstride=%d\trecords=%d\tbases=%d\tbytes=%d%s\n"
                % (FQI_MAGIC, index.stride, index.n_records,
                   index.n_bases, index.n_bytes,
                   "\tbgzf=1" if index.bgzf else ""))
        f.write("".join("%d\n" % o for o in index.offsets))


def read_fqi(path) -> FastqIndex:
    """Load a ``.fqi`` written by :func:`write_fqi`."""
    with open(str(path)) as f:
        header = f.readline().rstrip("\n").split("\t")
        if not header or header[0] != FQI_MAGIC or len(header) < 6:
            raise ParseError("not a blazeseq .fqi file: %s" % path)
        kv = dict(part.split("=", 1) for part in header[2:])
        offsets = np.loadtxt(f, dtype=np.int64, ndmin=1) if kv.get(
            "records") != "0" else np.empty(0, dtype=np.int64)
    return FastqIndex(stride=int(kv["stride"]), n_records=int(kv["records"]),
                      n_bases=int(kv["bases"]), n_bytes=int(kv["bytes"]),
                      offsets=offsets, bgzf=kv.get("bgzf") == "1")


class IndexedFastq:
    """Random access into a FASTQ file — plain or BGZF-compressed — via a
    ``.fqi`` sidecar (the FASTQ analog of
    :class:`~blazeseq_tpu.fai.parser.IndexedFasta`).

    Builds the index on first use when no ``<path>.fqi`` exists (and a
    sidecar whose recorded size disagrees with the file is rebuilt, not
    trusted). Usage::

        with IndexedFastq("reads.fastq") as ix:       # or reads.fastq.gz (BGZF)
            recs = ix.fetch(1_000_000, 10)   # records 1e6..1e6+9
            for start, count in ix.shard_records(8): ...
    """

    def __init__(self, path, fqi_path=None, stride: int = DEFAULT_STRIDE,
                 config=None, save: bool = True):
        self._path = str(path)
        self._config = config
        self._bgzf = self._path.endswith(".gz")
        sidecar = str(fqi_path) if fqi_path else self._path + ".fqi"
        self.index: Optional[FastqIndex] = None
        if os.path.exists(sidecar):
            ix = read_fqi(sidecar)
            if (ix.n_bytes == os.path.getsize(self._path)
                    and ix.bgzf == self._bgzf):
                self.index = ix
        if self.index is None:
            self.index = build_fqi(self._path, stride=stride, config=config)
            if save:
                write_fqi(self.index, sidecar)
        self._reader = None
        self._arr = None
        if not self._bgzf:
            from ..io.readers import MmapReader

            self._reader = MmapReader(self._path)
            self._arr = self._reader.as_array()  # None when mmap unavailable

    def __len__(self) -> int:
        return self.index.n_records

    def _parser_at(self, offset: int) -> FastqParser:
        if self._bgzf:
            from ..io.readers import BgzfReader

            return FastqParser(BgzfReader(self._path, voffset=offset),
                               config=self._config)
        if self._arr is not None:
            from ..io.readers import MemoryReader

            return FastqParser(MemoryReader(self._arr[offset:]),
                               config=self._config)
        from ..io.readers import FileReader

        r = FileReader(self._path)
        r._f.seek(offset)
        return FastqParser(r, config=self._config)

    def stream_records(self, start: int, count: int):
        """Yield records ``start .. start+count-1`` (owned copies) without
        materializing the batch: seek to the nearest index checkpoint
        (a byte offset, or a BGZF virtual offset resolved with one block
        seek), skip at most ``stride - 1`` records with the zero-copy view
        iterator, then stream."""
        if count < 1:
            return
        off, skip = self.index.checkpoint_for(start)
        stop = min(start + count, self.index.n_records)
        want = stop - start
        parser = self._parser_at(off)
        it = parser.views(reuse=True)
        for _ in range(skip):
            next(it)
        got = 0
        for rec in parser.records():
            yield rec
            got += 1
            if got == want:
                return

    def fetch(self, start: int, count: int = 1) -> List[FastqRecord]:
        """``list(stream_records(start, count))``."""
        return list(self.stream_records(start, count))

    def shard_records(self, n: int) -> List[tuple]:
        """Split the file into ``n`` record ranges ``(start, count)`` that
        each begin on an index checkpoint and jointly cover every record —
        the format-agnostic sharding API (works for plain and BGZF inputs;
        consume each with :meth:`stream_records`). Fewer than ``n`` ranges
        come back when there are fewer checkpoints than shards."""
        if n < 1:
            raise ValueError("n must be >= 1")
        ix = self.index
        if ix.n_records == 0:
            return []
        n_ckpt = len(ix.offsets)
        picks = sorted({(i * n_ckpt) // n for i in range(min(n, n_ckpt))})
        starts = [k * ix.stride for k in picks]
        bounds = starts + [ix.n_records]
        return [(bounds[i], bounds[i + 1] - bounds[i])
                for i in range(len(bounds) - 1)]

    def shard_ranges(self, n: int) -> List[tuple]:
        """Split a *plain* file into ``n`` byte ranges ``[lo, hi)`` that each
        start exactly on a record boundary and jointly cover every record —
        exact file sharding with no speculative rescan (feeds
        parallel/pipeline.py's byte-range shards). For BGZF inputs byte
        ranges are meaningless mid-block; use :meth:`shard_records`."""
        if n < 1:
            raise ValueError("n must be >= 1")
        if self._bgzf:
            raise ParseError(
                "byte-range shards are undefined inside BGZF blocks; use "
                "shard_records(n) + stream_records(start, count) instead")
        ix = self.index
        if ix.n_records == 0:
            return []
        n_ckpt = len(ix.offsets)
        # pick n roughly-equidistant checkpoints as shard starts (always
        # including record 0); granularity is the index stride
        picks = sorted({int(ix.offsets[(i * n_ckpt) // n])
                        for i in range(min(n, n_ckpt))})
        bounds = picks + [ix.n_bytes]
        return [(bounds[i], bounds[i + 1]) for i in range(len(bounds) - 1)]

    def close(self) -> None:
        if self._reader is not None:
            self._reader.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
