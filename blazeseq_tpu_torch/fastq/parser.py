"""FASTQ parser — chunk-vectorized host engine
(reference behavior spec: blazeseq/fastq/parser.mojo).

Architectural departure from the reference: instead of a per-record SIMD scan
state machine resumed across buffer refills (parser.mojo:311-379, 452-522),
this parser scans an entire buffered window per call through the native bulk
kernel (blazeseq_tpu/native), producing offset tables for thousands of records
at once with structure checks and optional ASCII/quality validation fused into
the same pass. Python-level work is O(1) per window for the batch path and
O(1) per record (one view object) for the view/record paths.

API parity with the reference:
  * three modes: next_view()/views(), next_record()/records(),
    next_batch()/batches() (parser.mojo:160-274)
  * identical error classes, messages, and record/line/file-position context
  * identical edge semantics: id whitespace-stripping, CR retention in
    seq/qual, EOF-without-trailing-newline (utils.mojo:294-329), trailing
    blank-line acceptance, buffer capacity errors
  * EOF signalled as FastxEOFError("EOF")

One deliberate divergence: iterators raise parse/validation errors instead of
printing and swallowing them (reference wart, parser.mojo:649-661).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from .. import native, tracing
from ..constants import (
    DEFAULT_BATCH_SIZE,
    DEFAULT_CAPACITY,
    DEFAULT_CHUNK_SIZE,
    MAX_CAPACITY,
)
from ..errors import (
    FastxEOFError,
    FastxErrorCode,
    ParseError,
    ValidationError,
    validation_error_from_code,
)
from ..io.buffered import ByteStream
from .batch import FastqBatch
from .quality import GENERIC_SCHEMA, QualitySchema, parse_schema
from .record import FastqRecord, FastqView, strip_spaces


@dataclass
class ParserConfig:
    """Parser options (reference: parser.mojo:33-74). In the reference this is
    a comptime parameter; here it is runtime config — validation flags are
    plain ints passed to the native kernel, and the device pipeline
    specializes on them at jit-trace time."""

    buffer_capacity: int = DEFAULT_CAPACITY
    buffer_max_capacity: int = MAX_CAPACITY
    buffer_growth_enabled: bool = False
    check_ascii: bool = False
    check_quality: bool = False
    quality_schema: Optional[str] = None


_BLANK = frozenset(b"\n\r \t")
_WS = frozenset(b" \t\n\v\f\r\x1c\x1d\x1e")
_POSIX_WS_BYTES = b" \t\n\v\f\r\x1c\x1d\x1e"


class _BoundIterableMethod:
    """Callable that is also directly iterable: `p.records()` and
    `for r in p.records` both work (method style mirrors the reference core
    library, bare-iterable style mirrors its Python binding wrappers,
    python/blazeseq/__init__.py:188-230)."""

    __slots__ = ("_fn", "_obj")

    def __init__(self, fn, obj):
        self._fn = fn
        self._obj = obj

    def __call__(self, *args, **kwargs):
        return self._fn(self._obj, *args, **kwargs)

    def __iter__(self):
        return iter(self._fn(self._obj))


class _iterable_method:
    """Descriptor form of _BoundIterableMethod."""

    def __init__(self, fn):
        self._fn = fn
        self.__doc__ = fn.__doc__

    def __set_name__(self, owner, name):
        self.__name__ = name

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self._fn
        return _BoundIterableMethod(self._fn, obj)


class FastqParser:
    """Unified FASTQ parser over a Reader (reference: parser.mojo:77-145)."""

    def __init__(
        self,
        reader,
        quality_schema: Optional[str] = None,
        batch_size: int = DEFAULT_BATCH_SIZE,
        config: Optional[ParserConfig] = None,
    ):
        self.config = config or ParserConfig()
        if quality_schema is not None:
            self.quality_schema: QualitySchema = parse_schema(quality_schema)
        elif self.config.quality_schema is not None:
            self.quality_schema = parse_schema(self.config.quality_schema)
        else:
            self.quality_schema = GENERIC_SCHEMA
        self._stream = ByteStream(reader, chunk_size=DEFAULT_CHUNK_SIZE)
        self._batch_size = batch_size
        self._served = 0  # records handed out or consumed (== line_number/4)
        # scanned-but-unserved queue: absolute offsets into the stream buffer
        self._q: np.ndarray = np.empty((0, 5), dtype=np.int64)
        self._q_rows = None  # lazy tolist() mirror for O(1) per-view access
        self._q_pos = 0
        self._mv = None  # cached buffer memoryview, refreshed per scan
        self._pending_exc_info = None  # (code, id_bytes, seq_bytes)
        # reusable offsets scratch (native.scan_fastq): the queue is always
        # drained before the next scan, so overwriting it is safe; 64K rows
        # per scan keeps allocations and page-fault churn off the hot path
        self._scan_scratch = None
        # SoA batch staging: adaptive output sizing (bytes / id-bytes per
        # record learned from the previous batch) + optional reusable pool
        self._soa_bpr = None
        self._soa_ipr = None
        self._soa_pool = None
        # C chain-iterator coordination (native/records_ext.c ChainIter):
        # the epoch word invalidates a chain's snapshot whenever the queue
        # moves underneath it; the attached chain mirrors its per-record
        # cursor into _chain_progress so _sync_chain can commit without
        # holding a reference to the iterator object (no ref cycles)
        self._epoch = np.zeros(1, dtype=np.int64)
        self._chain_attached = False
        self._chain_base = 0
        self._chain_progress = None

    def _sync_chain(self) -> None:
        """Commit and detach the active C chain iterator (if any): its
        served-record count moves the queue cursor, and the epoch bump makes
        the chain re-snapshot through its refill on next use. Idempotent;
        called at the head of every entry point that touches the queue."""
        if not self._chain_attached:
            return
        served = int(self._chain_progress[0])
        self._chain_attached = False
        self._chain_progress = None
        self._q_pos = self._chain_base + served
        self._served += served
        self._epoch[0] += 1

    # -- bookkeeping -----------------------------------------------------------
    def has_more(self) -> bool:
        self._sync_chain()
        return (
            self._q_pos < len(self._q)
            or self._pending_exc_info is not None
            or self._stream.has_more()
        )

    def _queue_len(self) -> int:
        return len(self._q) - self._q_pos

    def records_served(self) -> int:
        """Total records handed out or consumed so far (any mode)."""
        self._sync_chain()
        return self._served

    # -- error construction ----------------------------------------------------
    def _raise_parse_error(self, code: FastxErrorCode, err_off: np.ndarray) -> None:
        """Structure error at the next unserved record (reference context:
        parser.mojo:332-338 — record/line 1-indexed, position = record start)."""
        buf = self._stream.mview()
        h = int(err_off[0])
        rel_end = int(err_off[4]) - h if err_off[4] >= 0 else len(buf) - h
        end = min(h + rel_end + 1, len(buf), h + 200)
        snippet = bytes(buf[h:end]).decode("utf-8", "replace") if end > h else ""
        raise ParseError(
            code.message(),
            record_number=self._served + 1,
            line_number=self._served * 4 + 1,
            file_position=self._stream.stream_position(),
            record_snippet=snippet,
            code=code,
        )

    def _raise_validation_error(self) -> None:
        code, id_b, seq_b = self._pending_exc_info
        self._pending_exc_info = None
        self._served += 1  # the failing record was consumed (parser.mojo:375-377)
        snippet = id_b.decode("utf-8", "replace")
        if snippet:
            snippet += "\n"
        room = 200 - len(snippet)
        if room > 0:
            snippet += seq_b[:room].decode("utf-8", "replace")
        raise validation_error_from_code(
            FastxErrorCode(code), self._served, "", snippet
        )

    # -- scanning --------------------------------------------------------------
    def _scan_more(self) -> None:
        """Refill + scan the window, populating the record queue. Called only
        when the queue is empty (so buffer mutation never invalidates served
        offsets)."""
        if self._pending_exc_info is not None:
            self._raise_validation_error()
        s = self._stream
        cfg = self.config
        if s.available() == 0:
            s.fill()
        if not s.has_more():
            raise FastxEOFError()
        if self._scan_scratch is None and native.has_native():
            self._scan_scratch = np.empty(((1 << 16) + 1, 5), dtype=np.int64)
        while True:
            buf_np = s.window()
            res = native.scan_fastq(
                buf_np,
                start=s._head,
                check_ascii=cfg.check_ascii,
                check_quality=cfg.check_quality,
                q_lower=self.quality_schema.LOWER,
                q_upper=self.quality_schema.UPPER,
                scratch=self._scan_scratch,
            )
            if len(res.offsets) or res.err_code:
                self._ingest(res)
                return
            # no complete record in window
            partial_len = s.available()
            if s.is_eof():
                self._handle_eof_tail(res.err_phase)
                return
            if partial_len >= cfg.buffer_capacity:
                if not cfg.buffer_growth_enabled:
                    raise ParseError(
                        "FASTQ record exceeds buffer capacity (%d bytes). Enable"
                        " buffer growth or increase buffer_capacity."
                        % cfg.buffer_capacity,
                        code=FastxErrorCode.BUFFER_EXCEEDED,
                    )
                if partial_len >= cfg.buffer_max_capacity:
                    raise ParseError(
                        "FASTQ record exceeds maximum buffer capacity (%d"
                        " bytes). Enable buffer growth or increase max_capacity."
                        % cfg.buffer_max_capacity,
                        code=FastxErrorCode.BUFFER_AT_MAX,
                    )
            if s.fill() == 0 and s.available() == 0:
                raise FastxEOFError()

    def _ingest(self, res: native.ScanResult) -> None:
        s = self._stream
        offsets = res.offsets
        code = res.err_code
        # per-record capacity enforcement (reference fixed-buffer semantics:
        # a record larger than buffer_capacity raises unless growth is on,
        # parser.mojo:484-503)
        if len(offsets):
            cap = (self.config.buffer_max_capacity
                   if self.config.buffer_growth_enabled
                   else self.config.buffer_capacity)
            sizes = offsets[:, 4] + 1 - offsets[:, 0]
            too_big = sizes > cap
            if too_big.any():
                k = int(np.argmax(too_big))
                if k == 0:
                    if self.config.buffer_growth_enabled:
                        raise ParseError(
                            "FASTQ record exceeds maximum buffer capacity (%d"
                            " bytes). Enable buffer growth or increase"
                            " max_capacity." % self.config.buffer_max_capacity,
                            code=FastxErrorCode.BUFFER_AT_MAX,
                        )
                    raise ParseError(
                        "FASTQ record exceeds buffer capacity (%d bytes)."
                        " Enable buffer growth or increase buffer_capacity."
                        % self.config.buffer_capacity,
                        code=FastxErrorCode.BUFFER_EXCEEDED,
                    )
                # serve the good prefix; the oversized record is re-detected
                # on the next scan (its bytes are not consumed)
                offsets = offsets[:k]
                res = res._replace(
                    offsets=offsets, consumed=int(offsets[-1, 4]) + 1,
                    err_code=0, err_offsets=None)
                code = 0
        if code in (1, 2, 3):  # structure error: bad record NOT consumed
            # consume the good ones; error raised when queue drains
            s.consume(res.consumed - s._head)
            self._q = offsets
            self._q_rows = None
            self._q_pos = 0
            self._mv = None
            if len(offsets) == 0:
                self._raise_parse_error(FastxErrorCode(code), res.err_offsets)
            # stash structure error info implicitly: it will be re-detected on
            # the next scan (record bytes are still in the buffer)
            return
        if code in (4, 5):  # validation error: bad record consumed, not served
            bad = offsets[-1]
            buf = s.mview()
            id_b = strip_spaces(bytes(buf[int(bad[0]) + 1 : int(bad[1]) - 1]))
            seq_b = bytes(buf[int(bad[1]) : int(bad[2]) - 1])
            self._pending_exc_info = (code, id_b, seq_b)
            offsets = offsets[:-1]
        s.consume(res.consumed - s._head)
        self._q = offsets
        self._q_rows = None  # materialized lazily by the view path
        self._q_pos = 0
        self._mv = None
        if len(offsets) == 0 and self._pending_exc_info is not None:
            self._raise_validation_error()

    def _handle_eof_tail(self, phase: int) -> None:
        """EOF with a trailing partial record (reference: utils.mojo:294-329 +
        parser.mojo:464-482)."""
        s = self._stream
        tail = bytes(s.mview()[s._head :])
        if not tail:
            raise FastxEOFError()
        nl = [i for i, b in enumerate(tail) if b == 10]
        if len(nl) >= 3:
            qual_start = nl[2] + 1
            rest = tail[qual_start:]
            if all(b in _BLANK for b in rest):
                raise FastxEOFError()  # file ends with blank lines
            # valid last record without trailing newline; structure checks are
            # skipped (reference _next_ref_complete EOF/QUAL path returns OK)
            h = s._head
            off = np.array(
                [[h, h + nl[0] + 1, h + nl[1] + 1, h + qual_start,
                  h + len(tail)]],
                dtype=np.int64,
            )
            # fused validation for the synthesized record
            if self.config.check_ascii or self.config.check_quality:
                code = self._validate_tail(off[0])
                if code:
                    buf = s.mview()
                    id_b = strip_spaces(
                        bytes(buf[int(off[0, 0]) + 1 : int(off[0, 1]) - 1]))
                    seq_b = bytes(buf[int(off[0, 1]) : int(off[0, 2]) - 1])
                    self._pending_exc_info = (code, id_b, seq_b)
                    s.consume(len(tail))
                    self._raise_validation_error()
            self._q = off
            self._q_rows = None
            self._q_pos = 0
            self._mv = None
            s.consume(len(tail))
            return
        raise ParseError(
            "Unexpected end of file in FASTQ record at phase %d" % len(nl),
            code=FastxErrorCode.UNEXPECTED_EOF,
        )

    def _validate_tail(self, off: np.ndarray) -> int:
        buf = self._stream.mview()
        h, sS, p, q, e = (int(x) for x in off)
        if self.config.check_ascii:
            if not (bytes(buf[h + 1 : p - 1]).isascii()
                    and bytes(buf[q:e]).isascii()):
                return 4
        if self.config.check_quality:
            qb = bytes(buf[q:e])
            if qb and (min(qb) < self.quality_schema.LOWER
                       or max(qb) > self.quality_schema.UPPER):
                return 5
        return 0

    # -- record materialization --------------------------------------------------
    def _view_at(self, row) -> FastqView:
        buf = self._mv
        if buf is None:
            buf = self._mv = self._stream.mview()
        h, sS, p, q, e = row
        # strip POSIX whitespace from id (reference: parser.mojo:368-371);
        # fast path: boundary bytes are non-whitespace for typical ids
        a, b = h + 1, sS - 1
        if b > a and (buf[a] in _WS or buf[b - 1] in _WS):
            stripped = strip_spaces(bytes(buf[a:b]))
            lead = (b - a) - len(
                bytes(buf[a:b]).lstrip(b" \t\n\v\f\r\x1c\x1d\x1e"))
            a += lead
            b = a + len(stripped)
        return FastqView(
            buf[a:b], buf[sS : p - 1], buf[q:e], self.quality_schema.OFFSET
        )

    # -- public: single-record modes ---------------------------------------------
    def next_view(self) -> FastqView:
        """Zero-copy next record (reference: parser.mojo:160-170). The view is
        invalidated by the next parser call that refills the window."""
        self._sync_chain()
        if self._q_pos >= len(self._q):
            self._scan_more()
        if self._q_rows is None:
            self._q_rows = self._q.tolist()
        row = self._q_rows[self._q_pos]
        self._q_pos += 1
        self._served += 1
        return self._view_at(row)

    def next_record(self) -> FastqRecord:
        """Owned next record (reference: parser.mojo:189-211)."""
        if not self.has_more():
            raise FastxEOFError()
        v = self.next_view()
        return v.to_record()

    def next_batch(self, max_records: int = DEFAULT_BATCH_SIZE,
                   reuse_buffers: bool = False) -> FastqBatch:
        """SoA batch of up to max_records (reference: parser.mojo:239-251):
        stops early at EOF; non-EOF errors propagate. The hot path is the
        fused native scan+validate+gather (bytes touched once); the
        offsets-queue path handles mixed usage, errors, and fallbacks.

        reuse_buffers=True serves the batch as views into parser-owned
        staging buffers (zero allocations in steady state — the bulk-feed
        fast path, same contract as padded_batches(reuse_buffers=True)):
        the arrays are INVALIDATED by the next next_batch call. The default
        returns independently owned arrays."""
        self._sync_chain()
        limit = max_records or self._batch_size
        out: Optional[FastqBatch] = None
        parts = []
        got = 0
        s = self._stream
        cfg = self.config
        while got < limit:
            if self._q_pos >= len(self._q):
                # fused fast path straight from the byte window
                if (native.has_native() and self._pending_exc_info is None
                        and (s.available() or not s.is_eof())):
                    if s.available() == 0 and s.fill() == 0 \
                            and s.available() == 0:
                        break
                    want = limit - got
                    # adaptive sizing: the first batch assumes worst-case
                    # 512 B/record; later batches size from the measured
                    # bytes-per-record (+30%), cutting fresh page churn ~2x
                    if self._soa_bpr is not None:
                        cap_b = min(want * self._soa_bpr * 13 // 10 + 4096,
                                    want * 512)
                        id_cap = min(want * self._soa_ipr * 3 // 2 + 1024,
                                     want * 64)
                    else:
                        cap_b = want * 512
                        id_cap = max(want * 64, 1 << 12)
                    cap_b = max(min(cap_b, s.available()), 1 << 16)
                    # the pool serves only the first part: a later scan in
                    # the same call would overwrite the earlier part's views
                    if reuse_buffers and not parts:
                        pool = self._soa_pool
                        if (pool is None or len(pool[0]) < cap_b
                                or len(pool[2]) < want
                                or len(pool[3]) < id_cap):
                            pool = (np.empty(cap_b, dtype=np.uint8),
                                    np.empty(cap_b, dtype=np.uint8),
                                    np.empty(want, dtype=np.int64),
                                    np.empty(id_cap, dtype=np.uint8),
                                    np.empty(want, dtype=np.int64))
                            self._soa_pool = pool
                        seq_out, qual_out, ends, ids, id_ends = pool
                    else:
                        seq_out = np.empty(cap_b, dtype=np.uint8)
                        qual_out = np.empty(cap_b, dtype=np.uint8)
                        ends = np.empty(want, dtype=np.int64)
                        ids = np.empty(id_cap, dtype=np.uint8)
                        id_ends = np.empty(want, dtype=np.int64)
                    r = native.scan_gather_soa(
                        s.window(), s._head, want,
                        cfg.check_ascii, cfg.check_quality,
                        self.quality_schema.LOWER, self.quality_schema.UPPER,
                        seq_out, qual_out, ends, ids, id_ends)
                    if r is not None:
                        count, total, id_total, consumed, err, phase = r
                        if err == -9 or (err == -8 and count == 0):
                            # -9: ASCII pre-filter tripped — DISCARD this
                            # output (it may hold non-ASCII records) and use
                            # the offsets path for exact semantics.
                            # -8 with no progress: a record larger than the
                            # output buffers — the offsets path enforces the
                            # buffer-capacity contract.
                            try:
                                self._scan_more()
                            except FastxEOFError:
                                break
                            continue
                        if count:
                            s.consume(consumed - s._head)
                            self._served += count
                            got += count
                            self._soa_bpr = total // count + 1
                            self._soa_ipr = id_total // count + 1
                            parts.append((seq_out[:total], qual_out[:total],
                                          ends[:count], ids[:id_total],
                                          id_ends[:count]))
                            continue  # includes -8-with-progress: fresh bufs
                        if err > 0:
                            # exact error context via the offsets path
                            # (always raises: bad record sits at the head)
                            self._scan_more()
                            raise AssertionError("unreachable")
                        # err == 0, count == 0: window ends mid-record
                        if s.is_eof():
                            if s.available() == 0:
                                break
                            try:
                                self._handle_eof_tail(phase)
                            except FastxEOFError:
                                break
                            continue  # tail record queued; drain below
                        # buffer-capacity contract (same as next_padded /
                        # _scan_more): a record larger than the configured
                        # buffer must raise, not grow without bound
                        if s.available() >= cfg.buffer_capacity:
                            if not cfg.buffer_growth_enabled:
                                raise ParseError(
                                    "FASTQ record exceeds buffer capacity"
                                    " (%d bytes). Enable buffer growth or"
                                    " increase buffer_capacity."
                                    % cfg.buffer_capacity,
                                    code=FastxErrorCode.BUFFER_EXCEEDED)
                            if s.available() >= cfg.buffer_max_capacity:
                                raise ParseError(
                                    "FASTQ record exceeds maximum buffer"
                                    " capacity (%d bytes). Enable buffer"
                                    " growth or increase max_capacity."
                                    % cfg.buffer_max_capacity,
                                    code=FastxErrorCode.BUFFER_AT_MAX)
                        if s.fill() == 0 and s.available() == 0:
                            break
                        continue
                try:
                    self._scan_more()
                except FastxEOFError:
                    break
            take = min(limit - got, self._queue_len())
            rows = self._q[self._q_pos : self._q_pos + take]
            window = self._stream.window()
            seq, qual, ends = native.gather_soa(window, rows)
            ids, id_ends = native.gather_ids(window, rows)
            parts.append((seq, qual, ends, ids, id_ends))
            self._q_pos += take
            self._served += take
            got += take
        if not parts:
            return FastqBatch(quality_offset=self.quality_schema.OFFSET)
        if len(parts) == 1:
            seq, qual, ends, ids, id_ends = parts[0]
        else:
            seq = np.concatenate([p[0] for p in parts])
            qual = np.concatenate([p[1] for p in parts])
            ids = np.concatenate([p[3] for p in parts])
            ends_list, id_ends_list, base, id_base = [], [], 0, 0
            for p in parts:
                ends_list.append(p[2] + base)
                id_ends_list.append(p[4] + id_base)
                base += int(p[2][-1]) if len(p[2]) else 0
                id_base += int(p[4][-1]) if len(p[4]) else 0
            ends = np.concatenate(ends_list)
            id_ends = np.concatenate(id_ends_list)
        return FastqBatch.from_arrays(
            seq, qual, ends, ids, id_ends,
            quality_offset=self.quality_schema.OFFSET)

    def next_padded(self, max_records: int = DEFAULT_BATCH_SIZE,
                    max_len: int = 256, pad_records_to: Optional[int] = None,
                    _out=None):
        """Fill a padded [rows, max_len] device-layout batch straight from the
        byte window in one fused native pass (scan + structure/ASCII/quality
        validation + gather; reads longer than max_len are clamped). The
        host->HBM feed fast path. Error semantics match next_batch: non-EOF
        errors propagate and discard the partial batch.

        `_out=(seq, qual, lengths)` fills caller-provided buffers instead of
        allocating (used by padded_batches(reuse_buffers=True))."""
        with tracing.span("bs.parse.batch"):
            self._sync_chain()
            from .batch import PaddedFastqBatch

            limit = max_records or self._batch_size
            rows = max(limit, pad_records_to or 0)
            if _out is not None:
                seq, qual, lengths = _out
            else:
                with tracing.span("bs.parse.alloc"):
                    seq = native.aligned_empty((rows, max_len))
                    qual = native.aligned_empty((rows, max_len))
                    lengths = np.zeros(rows, dtype=np.int32)
            got = 0
            s = self._stream
            cfg = self.config
            cap = (cfg.buffer_max_capacity if cfg.buffer_growth_enabled
                   else cfg.buffer_capacity)
            while got < limit:
                # drain any queued offsets first (mixed view/batch usage)
                if self._q_pos < len(self._q):
                    take = min(limit - got, self._queue_len())
                    native.gather_padded(
                        s.window(), self._q[self._q_pos : self._q_pos + take],
                        max_len,
                        out=(seq[got : got + take], qual[got : got + take],
                             lengths[got : got + take]))
                    self._q_pos += take
                    self._served += take
                    got += take
                    continue
                if self._pending_exc_info is not None:
                    self._raise_validation_error()
                if s.available() == 0 and s.fill() == 0 and s.available() == 0:
                    break  # EOF
                r = native.scan_gather_padded(
                    s.window(), s._head, limit - got, max_len,
                    cfg.check_ascii, cfg.check_quality,
                    self.quality_schema.LOWER, self.quality_schema.UPPER,
                    cap, seq[got:], qual[got:], lengths[got:])
                if r is None:  # no native library: queue-based fallback
                    try:
                        self._scan_more()
                    except FastxEOFError:
                        break
                    continue
                count, consumed, err, phase = r
                if count:
                    s.consume(consumed - s._head)
                    self._served += count
                    got += count
                    continue
                if err:
                    # reproduce the exact error through the offset path (always
                    # raises: the bad record sits at the window head)
                    self._scan_more()
                    raise AssertionError("unreachable")
                # no complete record in window
                if s.is_eof():
                    if s.available() == 0:
                        break
                    try:
                        self._handle_eof_tail(phase)
                    except FastxEOFError:
                        break
                    continue  # synthesized tail record now queued
                if s.available() >= cfg.buffer_capacity:
                    if not cfg.buffer_growth_enabled:
                        raise ParseError(
                            "FASTQ record exceeds buffer capacity (%d bytes)."
                            " Enable buffer growth or increase"
                            " buffer_capacity."
                            % cfg.buffer_capacity,
                            code=FastxErrorCode.BUFFER_EXCEEDED)
                    if s.available() >= cfg.buffer_max_capacity:
                        raise ParseError(
                            "FASTQ record exceeds maximum buffer capacity (%d"
                            " bytes). Enable buffer growth or increase"
                            " max_capacity." % cfg.buffer_max_capacity,
                            code=FastxErrorCode.BUFFER_AT_MAX)
                if s.fill() == 0 and s.available() == 0:
                    break
            if got < rows:
                lengths[got:] = 0
            if got:
                tracing.count("parse.batches")
                tracing.count("parse.reads", got)
            return PaddedFastqBatch(seq=seq, qual=qual, lengths=lengths,
                                    n_records=got,
                                    quality_offset=self.quality_schema.OFFSET)

    def bucketed_padded_batches(self, buckets=(128, 256, 512, 1024),
                                max_records: Optional[int] = None):
        """Length-bucketed padded batches: each record goes to the smallest
        bucket width >= its read length, and a full [max_records, width]
        PaddedFastqBatch is yielded per bucket as it fills (partials flush at
        EOF). Yields (bucket_width, PaddedFastqBatch).

        This is the TPU-native mixed-length layout (SURVEY §5: long reads via
        padded/bucketed SoA): padding waste stays bounded per bucket instead
        of every batch paying for its longest read, while shapes remain
        static per bucket (one XLA compilation each). Records keep stream
        order within a bucket; ordering across buckets interleaves (QC
        statistics and counters are order-invariant). Reads longer than the
        largest bucket are clamped to it (lengths stay true)."""
        self._sync_chain()
        from .batch import PaddedFastqBatch

        buckets = sorted(set(int(b) for b in buckets))
        limit = max_records or self._batch_size
        acc = {
            w: (np.zeros((limit, w), dtype=np.uint8),
                np.zeros((limit, w), dtype=np.uint8),
                np.zeros(limit, dtype=np.int32))
            for w in buckets
        }
        fill = {w: 0 for w in buckets}
        widths = np.asarray(buckets, dtype=np.int64)

        def emit(w):
            seq, qual, lengths = acc[w]
            pb = PaddedFastqBatch(seq=seq, qual=qual, lengths=lengths,
                                  n_records=fill[w],
                                  quality_offset=self.quality_schema.OFFSET)
            acc[w] = (np.zeros((limit, w), dtype=np.uint8),
                      np.zeros((limit, w), dtype=np.uint8),
                      np.zeros(limit, dtype=np.int32))
            fill[w] = 0
            return pb

        while True:
            if self._q_pos >= len(self._q):
                try:
                    self._scan_more()
                except FastxEOFError:
                    break
            rows = self._q[self._q_pos :]
            window = self._stream.window()
            # cursor advances BEFORE any gather/yield (parser invariant: a
            # record is consumed exactly once even when the consumer
            # interleaves other parser calls or abandons the generator)
            self._served += len(rows)
            self._q_pos = len(self._q)
            lens = rows[:, 2] - rows[:, 1] - 1
            which = np.searchsorted(widths, lens, side="left")
            which = np.minimum(which, len(buckets) - 1)  # clamp long reads
            # gather the WHOLE queue into accumulators first; yields happen
            # only afterwards (a consumer may call back into the parser
            # during a yield, which can shift the window under us)
            full: list = []
            for bi in np.unique(which):
                w = buckets[int(bi)]
                sub = rows[which == bi]
                i = 0
                while i < len(sub):
                    take = min(limit - fill[w], len(sub) - i)
                    seq, qual, lengths = acc[w]
                    native.gather_padded(
                        window, sub[i : i + take], w,
                        out=(seq[fill[w] : fill[w] + take],
                             qual[fill[w] : fill[w] + take],
                             lengths[fill[w] : fill[w] + take]))
                    fill[w] += take
                    i += take
                    if fill[w] >= limit:
                        full.append((w, emit(w)))
            for item in full:
                yield item
        for w in buckets:
            if fill[w]:
                yield w, emit(w)

    def padded_batches(self, max_records: Optional[int] = None,
                       max_len: int = 256,
                       pad_records_to: Optional[int] = None,
                       reuse_buffers: bool = False):
        """Stream padded device-layout batches.

        With reuse_buffers=True, two buffer sets are rotated (double
        buffering): each yielded batch is invalidated two iterations later —
        the same contract as views mode (record.mojo:435-441). Use when every
        batch is consumed (device_put) before the next+1 iteration, which is
        the normal host->HBM feed pattern."""
        limit = max_records or self._batch_size
        outs = None
        if reuse_buffers:
            rows = max(limit, pad_records_to or 0)
            outs = [
                (native.aligned_empty((rows, max_len)),
                 native.aligned_empty((rows, max_len)),
                 np.zeros(rows, dtype=np.int32))
                for _ in range(2)
            ]
        i = 0
        while self.has_more():
            out = outs[i & 1] if outs is not None else None
            i += 1
            pb = self.next_padded(limit, max_len, pad_records_to, _out=out)
            if pb.n_records == 0:
                return
            yield pb

    # -- public: iterators ---------------------------------------------------------
    # Each mode works both as a method (core-library style, `parser.views()`,
    # reference fastq/parser.mojo:628-735) and as a bare iterable
    # (Python-binding style, `for r in parser.records`, reference
    # python/blazeseq/__init__.py:188-230).
    #
    # The iterator bodies bulk-drain each scanned offset queue instead of
    # going through next_view()/next_record() per record: objects are built
    # with __new__ + direct slot writes and byte slices come off one window
    # reference, so the per-record Python work is a few C-level operations.
    def _chain_iter(self, ext, out_type, is_view: bool,
                    reuse: bool = False):
        """Build a C chain iterator (native/records_ext.c): its refill
        callable commits the previous snapshot (via _sync_chain), scans when
        the queue is empty, and hands out a frozen (buffer, rows) snapshot +
        the new epoch. Raised errors (validation/parse) propagate out of the
        C iterator's __next__."""
        # NOTE: the progress array must be shared between the chain (writer)
        # and the parser (reader at commit); it is created here once and
        # re-armed (zeroed + installed) by every refill.
        progress = np.zeros(1, dtype=np.int64)

        def refill(_served):
            self._sync_chain()
            if self._pending_exc_info is not None and self._q_pos >= len(
                    self._q):
                self._raise_validation_error()
            if self._q_pos >= len(self._q):
                try:
                    self._scan_more()
                except FastxEOFError:
                    return None
            mv = self._mv
            if mv is None:
                mv = self._mv = self._stream.mview()
            rows = np.ascontiguousarray(self._q[self._q_pos:])
            n = len(rows)
            if n == 0:
                return None
            progress[0] = 0
            self._chain_attached = True
            self._chain_base = self._q_pos
            self._chain_progress = progress
            self._epoch[0] += 1
            return (mv, rows, n, int(self._epoch[0]))

        return ext.make_chain_iter(refill, self._epoch, progress,
                                   self.quality_schema.OFFSET, out_type,
                                   is_view, reuse)

    @_iterable_method
    def views(self, reuse: bool = False) -> Iterator[FastqView]:
        """Zero-copy record iteration (reference views mode,
        parser.mojo:628-661). With the C extension, iteration runs through
        a C chain iterator producing C view objects (one allocation, zero
        copies per record); otherwise the Python generator below.

        reuse=True serves ONE view shell mutated in place each iteration —
        the view contract already says a view is invalidated by the next
        parser operation (record.mojo:435-441); reuse makes the iteration
        itself that operation. Skips the per-record object create/destroy
        (the dominant per-object cost, docs/perf_views_floor.md); do not
        store the yielded view. Without the C extension this degrades to
        ordinary views (a strictly stronger guarantee)."""
        ext = native.records_ext()
        if ext is not None and issubclass(FastqView, ext.View):
            return self._chain_iter(ext, FastqView, True, reuse)
        return self._views_py()

    def _views_py(self) -> Iterator[FastqView]:
        off = self.quality_schema.OFFSET
        ws = _WS
        new = FastqView
        self._sync_chain()
        while True:
            if self._q_pos >= len(self._q):
                try:
                    self._scan_more()
                except FastxEOFError:
                    return
            buf = self._mv
            if buf is None:
                buf = self._mv = self._stream.mview()
            rows = self._q_rows
            if rows is None:
                rows = self._q_rows = self._q.tolist()
            qlen = len(rows)
            qid = self._q
            # cursor writes happen BEFORE each yield, and the loop re-syncs
            # when an interleaved parser call (next_batch etc.) replaced the
            # scan queue — so mixed iterator/direct usage never re-serves or
            # mis-serves a record
            while self._q_pos < qlen and self._q is qid:
                h, s, p, q, e = rows[self._q_pos]
                self._q_pos += 1
                self._served += 1
                a = h + 1
                b = s - 1
                if b > a and (buf[a] in ws or buf[b - 1] in ws):
                    stripped = bytes(buf[a:b]).strip(
                        b" \t\n\v\f\r\x1c\x1d\x1e")
                    lead = (b - a) - len(
                        bytes(buf[a:b]).lstrip(b" \t\n\v\f\r\x1c\x1d\x1e"))
                    a += lead
                    b = a + len(stripped)
                # constructor (not slot writes): works for both the C-based
                # and pure-Python class variants — this path can run with
                # C classes when only the scan kernel is unavailable
                yield new(buf[a:b], buf[s : p - 1], buf[q:e], off)

    @_iterable_method
    def records(self) -> Iterator[FastqRecord]:
        """Owned-record iteration (reference records mode,
        parser.mojo:662-700). With the C extension, iteration runs through
        a C chain iterator producing single-block C record objects (one
        allocation + one copy per record); otherwise the Python generator
        below."""
        ext = native.records_ext()
        if ext is not None and issubclass(FastqRecord, ext.Record):
            return self._chain_iter(ext, FastqRecord, False)
        return self._records_py()

    def _records_py(self) -> Iterator[FastqRecord]:
        off = self.quality_schema.OFFSET
        strip = _POSIX_WS_BYTES
        new = FastqRecord
        self._sync_chain()
        while True:
            if self._q_pos >= len(self._q):
                try:
                    self._scan_more()
                except FastxEOFError:
                    return
            # one bytes copy of the consumed window region per scan; slices
            # below are then C-level bytes ops
            mv = self._mv
            if mv is None:
                mv = self._mv = self._stream.mview()
            buf = bytes(mv)
            rows = self._q_rows
            if rows is None:
                rows = self._q_rows = self._q.tolist()
            qlen = len(rows)
            qid = self._q
            while self._q_pos < qlen and self._q is qid:
                h, s, p, q, e = rows[self._q_pos]
                self._q_pos += 1
                self._served += 1
                yield new(buf[h + 1 : s - 1].strip(strip), buf[s : p - 1],
                          buf[q:e], phred_offset=off)

    @_iterable_method
    def batches(self, max_records: Optional[int] = None,
                reuse_buffers: bool = False) -> Iterator[FastqBatch]:
        limit = max_records or self._batch_size
        while self.has_more():
            batch = self.next_batch(limit, reuse_buffers=reuse_buffers)
            if len(batch) == 0:
                return
            yield batch

    def batches_with_size(self, n: int) -> Iterator[FastqBatch]:
        """Alias mirroring the reference Python binding
        (python/blazeseq/__init__.py:188-230)."""
        return self.batches(n)

    # -- public: counting fast path --------------------------------------------------
    def count(self):
        """Count (records, bases) at full scan speed without materializing
        records — the views-mode benchmark equivalent (reference runner:
        benchmark/fastq-parser/run_blazeseq.mojo:21-60). Validation flags are
        honored (fused in the native pass)."""
        self._sync_chain()
        records = 0
        bases = 0
        cfg = self.config
        s = self._stream
        while True:
            if self._q_pos < len(self._q):
                rows = self._q[self._q_pos :]
                records += len(rows)
                bases += int((rows[:, 2] - rows[:, 1] - 1).sum())
                self._served += len(rows)
                self._q_pos = len(self._q)
            # count without building offset tables (validation fused)
            n_rec, n_bases, consumed, err, phase = native.count_fastq(
                s.window(), s._head,
                check_ascii=cfg.check_ascii, check_quality=cfg.check_quality,
                q_lower=self.quality_schema.LOWER,
                q_upper=self.quality_schema.UPPER)
            if err:
                # rescan with the offset path to produce the exact error
                self._served += n_rec
                s.consume(consumed - s._head)
                self._scan_more()
                raise AssertionError("unreachable")  # _scan_more raised
            records += n_rec
            bases += n_bases
            self._served += n_rec
            s.consume(consumed - s._head)
            if s.is_eof():
                if s.available():
                    try:
                        self._handle_eof_tail(phase)
                    except FastxEOFError:
                        break
                    rows = self._q[self._q_pos :]
                    records += len(rows)
                    bases += int((rows[:, 2] - rows[:, 1] - 1).sum())
                    self._served += len(rows)
                    self._q_pos = len(self._q)
                break
            if s.fill() == 0 and s.available() == 0:
                break
        return records, bases

    def offset_chunks(self):
        """Yield ``(first_record_index, starts, seq_lens)`` per internal scan
        batch, consuming the stream at scan speed without materializing
        records. ``starts`` are absolute byte offsets (in the decompressed
        stream) of each record's ``@`` byte; ``seq_lens`` are the sequence
        line lengths — both int64 arrays of equal length. Validation flags
        are honored (errors raise exactly where views()/count() would).

        Powers the ``.fqi`` record index (fastq/index.py). Random access is
        an open item upstream (reference README.md:129-134, docs/TODO.md:5-8:
        "end-to-end, no seek"); bulk offset extraction is the primitive that
        makes it possible here.
        """
        self._sync_chain()
        s = self._stream
        while True:
            if self._q_pos < len(self._q):
                rows = self._q[self._q_pos:]
                # buffer offset -> stream offset: consume() moves _head and
                # _consumed in lockstep, so their difference only changes on
                # compaction/growth — which _scan_more only performs while
                # the queue is empty. The delta is therefore constant for
                # every row of the current queue.
                base = s.stream_position() - s._head
                first = self._served
                self._served += len(rows)
                self._q_pos = len(self._q)
                yield (first, rows[:, 0] + base, rows[:, 2] - rows[:, 1] - 1)
            try:
                self._scan_more()
            except FastxEOFError:
                return
