"""Structure-of-Arrays FASTQ batches, host and device (counterpart of
blazeseq_tpu/fastq/batch.py).

`FastqBatch` is the host SoA batch: concatenated id / sequence / quality
byte arrays (numpy) with cumulative int64 end offsets and a quality offset,
built by the native gather in one pass. `to_padded()` gives a
`PaddedFastqBatch`: [n, L] uint8 rows zero-padded to a multiple of 128
columns and int32 lengths. `serialize_fastq_soa` / `serialize_fastq_rows`
write batches back out as FASTQ bytes.

The device side is functions beside the host classes:
`upload_batch_to_device` gives a `DeviceFastqBatch` of flat SoA tensors,
and `padded_to_device` a `PaddedFastqBatch` whose rows are tensors. Ids stay
on the host.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Optional

import numpy as np
import torch

from ..constants import DEFAULT_BATCH_SIZE, TPU_LANE
from ..ops.common import resolve_device
from .record import FastqRecord, FastqView


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class FastqBatch:
    """Host SoA batch of FASTQ records."""

    __slots__ = (
        "_id_bytes", "_sequence_bytes", "_quality_bytes",
        "_id_ends", "_ends", "_quality_offset",
        "_pend_ids", "_pend_seqs", "_pend_quals",
    )

    def __init__(self, batch_size: int = DEFAULT_BATCH_SIZE,
                 quality_offset: int = 33):
        self._id_bytes = np.empty(0, dtype=np.uint8)
        self._sequence_bytes = np.empty(0, dtype=np.uint8)
        self._quality_bytes = np.empty(0, dtype=np.uint8)
        self._id_ends = np.empty(0, dtype=np.int64)
        self._ends = np.empty(0, dtype=np.int64)
        self._quality_offset = quality_offset
        # incremental-add staging (finalized lazily)
        self._pend_ids: List[bytes] = []
        self._pend_seqs: List[bytes] = []
        self._pend_quals: List[bytes] = []

    # -- construction --------------------------------------------------------
    @classmethod
    def from_arrays(cls, seq: np.ndarray, qual: np.ndarray, ends: np.ndarray,
                    id_bytes: np.ndarray, id_ends: np.ndarray,
                    quality_offset: int = 33) -> "FastqBatch":
        b = cls(quality_offset=quality_offset)
        b._sequence_bytes = seq
        b._quality_bytes = qual
        b._ends = ends
        b._id_bytes = id_bytes
        b._id_ends = id_ends
        return b

    def deinterleave(self) -> tuple:
        """(even, odd) FastqBatch split by record parity — de-interleaves a
        single-stream R1/R2 batch into two index-aligned mate batches with
        one vectorized ragged gather per SoA column (no per-record Python)."""
        self._finalize()
        n = len(self._ends)
        if n % 2:
            raise ValueError("deinterleave: odd record count %d" % n)
        starts = np.concatenate([[0], self._ends[:-1]]).astype(np.int64)
        id_starts = np.concatenate([[0], self._id_ends[:-1]]).astype(np.int64)

        def ragged_take(flat, st, ln):
            total = int(ln.sum())
            if total == 0:
                return np.empty(0, np.uint8)
            base = np.repeat(st - np.concatenate(([0], np.cumsum(ln)[:-1])),
                             ln)
            return np.asarray(flat)[base + np.arange(total, dtype=np.int64)]

        out = []
        for off in (0, 1):
            idx = np.arange(off, n, 2)
            ln = (self._ends - starts)[idx]
            id_ln = (self._id_ends - id_starts)[idx]
            out.append(FastqBatch.from_arrays(
                ragged_take(self._sequence_bytes, starts[idx], ln),
                ragged_take(self._quality_bytes, starts[idx], ln),
                np.cumsum(ln).astype(np.int64),
                ragged_take(self._id_bytes, id_starts[idx], id_ln),
                np.cumsum(id_ln).astype(np.int64),
                quality_offset=self._quality_offset))
        return out[0], out[1]

    @classmethod
    def from_records(cls, records, quality_offset: int = 33) -> "FastqBatch":
        if not records:
            raise ValueError("FastqBatch cannot be empty")
        b = cls(quality_offset=quality_offset)
        for r in records:
            b.add(r)
        return b

    def add(self, record) -> None:
        """Append a FastqRecord or FastqView (reference: record_batch.mojo:65-87)."""
        self._pend_ids.append(bytes(record._id))
        self._pend_seqs.append(bytes(record._sequence))
        self._pend_quals.append(bytes(record._quality))

    def _finalize(self) -> None:
        if not self._pend_ids:
            return
        ids = b"".join(self._pend_ids)
        seqs = b"".join(self._pend_seqs)
        quals = b"".join(self._pend_quals)
        id_lens = np.fromiter((len(x) for x in self._pend_ids), dtype=np.int64)
        seq_lens = np.fromiter((len(x) for x in self._pend_seqs), dtype=np.int64)
        base_id = self._id_ends[-1] if len(self._id_ends) else 0
        base = self._ends[-1] if len(self._ends) else 0
        self._id_bytes = np.concatenate(
            [self._id_bytes, np.frombuffer(ids, dtype=np.uint8)])
        self._sequence_bytes = np.concatenate(
            [self._sequence_bytes, np.frombuffer(seqs, dtype=np.uint8)])
        self._quality_bytes = np.concatenate(
            [self._quality_bytes, np.frombuffer(quals, dtype=np.uint8)])
        self._id_ends = np.concatenate(
            [self._id_ends, base_id + np.cumsum(id_lens)])
        self._ends = np.concatenate([self._ends, base + np.cumsum(seq_lens)])
        self._pend_ids.clear()
        self._pend_seqs.clear()
        self._pend_quals.clear()

    # -- accessors ------------------------------------------------------------
    def num_records(self) -> int:
        self._finalize()
        return len(self._ends)

    def __len__(self) -> int:
        return self.num_records()

    def seq_len(self) -> int:
        self._finalize()
        return int(self._ends[-1]) if len(self._ends) else 0

    def quality_offset(self) -> int:
        return self._quality_offset

    def seq_lengths(self) -> np.ndarray:
        self._finalize()
        return np.diff(self._ends, prepend=0)

    def _bounds(self, ends: np.ndarray, i: int):
        start = int(ends[i - 1]) if i > 0 else 0
        return start, int(ends[i])

    def get_record(self, index: int) -> FastqRecord:
        """Random access via prefix-sum offsets (reference: record_batch.mojo:116-163)."""
        n = self.num_records()
        if index < 0 or index >= n:
            raise IndexError("FastqBatch.get_record index out of range")
        a, b = self._bounds(self._id_ends, index)
        c, d = self._bounds(self._ends, index)
        return FastqRecord(
            self._id_bytes[a:b].tobytes(),
            self._sequence_bytes[c:d].tobytes(),
            self._quality_bytes[c:d].tobytes(),
            phred_offset=self._quality_offset,
        )

    def get_ref(self, index: int) -> FastqView:
        """Zero-copy access (reference: record_batch.mojo:165-196)."""
        n = self.num_records()
        if index < 0 or index >= n:
            raise IndexError("FastqBatch.get_ref index out of range")
        a, b = self._bounds(self._id_ends, index)
        c, d = self._bounds(self._ends, index)
        return FastqView(
            memoryview(self._id_bytes)[a:b],
            memoryview(self._sequence_bytes)[c:d],
            memoryview(self._quality_bytes)[c:d],
            phred_offset=self._quality_offset,
        )

    def to_records(self) -> List[FastqRecord]:
        return [self.get_record(i) for i in range(self.num_records())]

    def write_to(self, writer) -> None:
        for i in range(self.num_records()):
            self.get_ref(i).write(writer)

    def __repr__(self) -> str:
        return "FastqBatch(records=%d, quality_offset=%d)" % (
            self.num_records(), self._quality_offset)

    # -- padding -----------------------------------------------------------
    def to_padded(self, max_len: Optional[int] = None,
                  pad_records_to: Optional[int] = None) -> "PaddedFastqBatch":
        """Build the padded [n, L] layout on host (numpy).

        Rows are zero-padded; L rounds up to the 128 TPU lane. With max_len,
        L is exactly max_len rounded up (static width across batches — one
        XLA compilation) and longer reads are clamped; lengths report TRUE
        read lengths so downstream counters stay exact (the padded-feed
        convention, next_padded). Optionally pads the record dimension to a
        fixed batch size too."""
        from .. import native

        self._finalize()
        n = len(self._ends)
        if max_len is not None:
            L = max_len
        else:
            L = int(np.diff(self._ends, prepend=0).max()) if n else 0
        L = max(_round_up(L, TPU_LANE), TPU_LANE)
        rows = n if pad_records_to is None else max(n, pad_records_to)
        # one memcpy a row (numpy's np.repeat scatter without the library)
        seq2d, qual2d, lengths = native.pad_rows(
            self._sequence_bytes, self._quality_bytes, self._ends, L, rows)
        return PaddedFastqBatch(
            seq=seq2d, qual=qual2d, lengths=lengths, n_records=n,
            quality_offset=self._quality_offset)


@dataclass
class PaddedFastqBatch:
    """Row-padded [n, L] batch — the canonical device kernel layout."""

    seq: object  # u8[n, L] (numpy, or a tensor after padded_to_device)
    qual: object  # u8[n, L]
    lengths: object  # i32[n]
    n_records: int
    quality_offset: int


@dataclass
class DeviceFastqBatch:
    """Flat SoA batch on a torch device."""

    seq: torch.Tensor  # u8[total]
    qual: torch.Tensor  # u8[total]
    ends: torch.Tensor  # i64[n] record end offsets into seq / qual
    quality_offset: int
    id_bytes: np.ndarray  # host
    id_ends: np.ndarray  # host

    def num_records(self) -> int:
        return int(self.ends.shape[0])

    def copy_to_host(self) -> FastqBatch:
        """Download the tensors back into a host batch equal to the one
        uploaded."""
        return FastqBatch.from_arrays(
            self.seq.cpu().numpy(), self.qual.cpu().numpy(),
            self.ends.cpu().numpy(), self.id_bytes, self.id_ends,
            self.quality_offset)

    def to_records(self) -> List[FastqRecord]:
        return self.copy_to_host().to_records()


def _put(a, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def upload_batch_to_device(batch: FastqBatch,
                           device="cuda") -> DeviceFastqBatch:
    """Upload a host batch's flat sequence, quality and end arrays to
    `device` ("cuda" needs a card and raises without one)."""
    dev = resolve_device(device, "upload_batch_to_device")
    batch._finalize()
    return DeviceFastqBatch(
        seq=_put(batch._sequence_bytes, dev),
        qual=_put(batch._quality_bytes, dev),
        ends=_put(np.asarray(batch._ends, np.int64), dev),
        quality_offset=batch.quality_offset(),
        id_bytes=batch._id_bytes,
        id_ends=batch._id_ends)


def padded_to_device(pb: PaddedFastqBatch, device="cuda") -> PaddedFastqBatch:
    """The padded batch with seq / qual u8[n, L] and lengths i32[n] as
    tensors on `device` ("cuda" needs a card and raises without one)."""
    dev = resolve_device(device, "padded_to_device")
    return replace(pb, seq=_put(pb.seq, dev), qual=_put(pb.qual, dev),
                   lengths=_put(np.asarray(pb.lengths, np.int32), dev))


def serialize_fastq_soa(id_bytes, id_ends, seq, qual, ends,
                        sub_start=None, sub_len=None) -> bytes:
    """Bulk FASTQ serialization of an SoA batch (the write-side
    complement of the bulk parser): one native memcpy pass per record,
    no per-record Python. Optional sub_start/sub_len (i64[n]) emit
    per-record sub-slices of seq/qual (the trimming case); records with
    sub_len <= 0 are dropped. Returns the '@id\nseq\n+\nqual\n'
    byte stream."""
    from .. import native

    id_ends = np.asarray(id_ends, np.int64)
    ends = np.asarray(ends, np.int64)
    id_starts = np.concatenate(([0], id_ends[:-1]))
    starts = np.concatenate(([0], ends[:-1]))
    if sub_len is None:
        offs = starts
        ln = ends - starts
    else:
        offs = starts + np.asarray(sub_start, np.int64) \
            if sub_start is not None else starts
        ln = np.asarray(sub_len, np.int64)
    return native.serialize_fastq(id_bytes, id_starts,
                                  id_ends - id_starts, seq, qual, offs, ln)


def serialize_fastq_rows(id_bytes, id_ends, seq_rows, qual_rows, lengths,
                         sub_start=None) -> bytes:
    """serialize_fastq_soa for padded [n, L] rows (lengths i32[n] are the
    emitted per-record lengths; rows with length 0 are dropped).
    sub_start offsets each row's slice start (the clip_ends case)."""
    from .. import native

    seq_rows = np.ascontiguousarray(seq_rows)
    qual_rows = np.ascontiguousarray(qual_rows)
    id_ends = np.asarray(id_ends, np.int64)
    n = len(np.asarray(lengths))
    L = seq_rows.shape[1]
    offs = np.arange(n, dtype=np.int64) * L
    if sub_start is not None:
        offs = offs + np.asarray(sub_start, np.int64)
    id_starts = np.concatenate(([0], id_ends[:-1]))
    return native.serialize_fastq(
        id_bytes, id_starts, id_ends - id_starts, seq_rows.reshape(-1),
        qual_rows.reshape(-1), offs, np.asarray(lengths, np.int64))
