"""Paired-end FASTQ reading (R1/R2 mate files).

Goes beyond the reference, whose TODO lists paired-end support as in
progress (reference docs/TODO.md:5-8, README.md:132): two synchronized
parsers yield mate pairs with id-consistency checking, plus a padded
pair-batch mode for device pipelines (mates side by side in HBM).

Mate ids match when their first header token is equal after stripping a
trailing '/1' / '/2' (classic convention) — Illumina's modern form keeps
the token identical and differs only in the comment, which already passes.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

from ..errors import ParseError
from .parser import DEFAULT_BATCH_SIZE, FastqParser, ParserConfig
from .record import FastqRecord


class PairSyncError(ParseError):
    """Mate files out of sync: mismatched ids or unequal record counts."""


def _pair_key(id_bytes: bytes) -> bytes:
    token = id_bytes.split(b" ", 1)[0].split(b"\t", 1)[0]
    if len(token) > 2 and token[-2:] in (b"/1", b"/2"):
        token = token[:-2]
    return token


class PairedFastqParser:
    """Synchronized R1/R2 parsing with id-consistency checks."""

    def __init__(self, r1_reader, r2_reader,
                 config: Optional[ParserConfig] = None,
                 check_ids: bool = True,
                 quality_schema: Optional[str] = None):
        self.r1 = FastqParser(r1_reader, quality_schema=quality_schema,
                              config=config)
        self.r2 = FastqParser(r2_reader, quality_schema=quality_schema,
                              config=config)
        self.check_ids = check_ids
        self._pair_number = 0

    def has_more(self) -> bool:
        return self.r1.has_more() or self.r2.has_more()

    def _check(self, a: FastqRecord, b: FastqRecord) -> None:
        if self.check_ids and _pair_key(a.id_bytes()) != _pair_key(
                b.id_bytes()):
            raise PairSyncError(
                "Mate id mismatch at pair %d: %r vs %r"
                % (self._pair_number, a.id_bytes(), b.id_bytes()))

    def next_pair(self) -> Tuple[FastqRecord, FastqRecord]:
        from ..errors import FastxEOFError

        try:
            a = self.r1.next_record()
        except FastxEOFError:
            if self.r2.has_more():
                raise PairSyncError(
                    "R1 ended at pair %d but R2 has more records"
                    % self._pair_number)
            raise
        try:
            b = self.r2.next_record()
        except FastxEOFError:
            raise PairSyncError(
                "R2 ended at pair %d but R1 has more records"
                % self._pair_number)
        self._pair_number += 1
        self._check(a, b)
        return a, b

    def pairs(self) -> Iterator[Tuple[FastqRecord, FastqRecord]]:
        from ..errors import FastxEOFError

        while True:
            try:
                yield self.next_pair()
            except FastxEOFError:
                return

    def padded_pair_batches(self, max_records: int = DEFAULT_BATCH_SIZE,
                            max_len: int = 256,
                            pad_records_to: Optional[int] = None):
        """Yield (pb1, pb2) padded batches with equal n_records — mates stay
        index-aligned, the layout device kernels want for fragment-level
        work. Id checking is not applied in this mode (ids are not carried
        in padded batches); use pairs() when that matters."""
        while True:
            pb1 = self.r1.next_padded(max_records, max_len, pad_records_to)
            pb2 = self.r2.next_padded(max_records, max_len, pad_records_to)
            if pb1.n_records != pb2.n_records:
                raise PairSyncError(
                    "mate files have unequal record counts near pair %d"
                    % (self._pair_number + min(pb1.n_records, pb2.n_records)))
            if pb1.n_records == 0:
                return
            self._pair_number += pb1.n_records
            yield pb1, pb2

    def count(self):
        """(pairs, bases_r1, bases_r2); raises PairSyncError on count skew."""
        r1, b1 = self.r1.count()
        r2, b2 = self.r2.count()
        if r1 != r2:
            raise PairSyncError(
                "mate files have unequal record counts: %d vs %d" % (r1, r2))
        return r1, b1, b2


class InterleavedFastqParser:
    """Paired-end reading from ONE interleaved stream (R1, R2, R1, R2, ...)
    — the other common paired layout (e.g. `bwa -p`, SRA dumps). Yields
    the same pair/pair-batch surface as PairedFastqParser; an odd trailing
    record or a mate-id mismatch raises PairSyncError."""

    def __init__(self, reader, config: Optional[ParserConfig] = None,
                 check_ids: bool = True,
                 quality_schema: Optional[str] = None):
        self.parser = FastqParser(reader, quality_schema=quality_schema,
                                  config=config)
        self.check_ids = check_ids
        self._pair_number = 0

    def has_more(self) -> bool:
        return self.parser.has_more()

    def _check(self, a: FastqRecord, b: FastqRecord) -> None:
        if self.check_ids and _pair_key(a.id_bytes()) != _pair_key(
                b.id_bytes()):
            raise PairSyncError(
                "Mate id mismatch at pair %d: %r vs %r"
                % (self._pair_number, a.id_bytes(), b.id_bytes()))

    def next_pair(self) -> Tuple[FastqRecord, FastqRecord]:
        from ..errors import FastxEOFError

        a = self.parser.next_record()  # EOF here ends the stream cleanly
        try:
            b = self.parser.next_record()
        except FastxEOFError:
            raise PairSyncError(
                "interleaved stream ended with an unpaired R1 at pair %d"
                % self._pair_number)
        self._pair_number += 1
        self._check(a, b)
        return a, b

    def pairs(self) -> Iterator[Tuple[FastqRecord, FastqRecord]]:
        from ..errors import FastxEOFError

        while True:
            try:
                yield self.next_pair()
            except FastxEOFError:
                return

    def padded_pair_batches(self, max_records: int = DEFAULT_BATCH_SIZE,
                            max_len: int = 256,
                            pad_records_to: Optional[int] = None):
        """Yield (pb1, pb2) by de-interleaving 2*max_records rows: even
        rows are R1, odd rows R2 — one parse, two index-aligned padded
        batches. Ids are not carried in padded batches (use pairs() for id
        checking)."""
        import numpy as np

        from .batch import PaddedFastqBatch

        while True:
            pb = self.parser.next_padded(2 * max_records, max_len,
                                         None)
            n = pb.n_records
            if n == 0:
                return
            if n % 2:
                raise PairSyncError(
                    "interleaved stream ended with an unpaired R1 at "
                    "pair %d" % (self._pair_number + n // 2))
            halves = []
            for off in (0, 1):
                rows = n // 2 if pad_records_to is None \
                    else max(n // 2, pad_records_to)
                seq = np.zeros((rows, pb.seq.shape[1]), np.uint8)
                qual = np.zeros_like(seq)
                lengths = np.zeros(rows, np.int32)
                seq[: n // 2] = np.asarray(pb.seq)[off:n:2]
                qual[: n // 2] = np.asarray(pb.qual)[off:n:2]
                lengths[: n // 2] = np.asarray(pb.lengths)[off:n:2]
                halves.append(PaddedFastqBatch(
                    seq=seq, qual=qual, lengths=lengths, n_records=n // 2,
                    quality_offset=pb.quality_offset))
            self._pair_number += n // 2
            yield halves[0], halves[1]

    def count(self):
        """(pairs, total_bases); raises PairSyncError on an odd record
        count."""
        r, b = self.parser.count()
        if r % 2:
            raise PairSyncError(
                "interleaved stream has an odd record count: %d" % r)
        return r // 2, b
