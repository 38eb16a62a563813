"""QCModel: streaming FastQC-style quality control of a FASTQ file
(counterpart of blazeseq_tpu/models/qc.py: the uniform-layout tier and the
host-parse path).

`run_file(path)` (and `run_reader` / `run_parser`) parses on the host into
padded batches; the device runs validate + QC and, with `align_to`, the
alignment kernel on each batch (parallel/pipeline.py), plus the adapter
scan, the read hashes of the duplication panel and the per-position
quality distribution when asked for. Device totals are flushed to the host
int64 accumulator every 64 batches.

`run_file_device(path)` covers core QC only. It maps the file, reads the
record layout from its head, and sends rs-aligned raw byte chunks to the
device through the overlapped feed (parallel/ingest.py). One pass per chunk
proves the layout and computes every QC panel (ops/uniform_qc.py); the host
adds the results in int64. Input outside that tier goes through
`_host_consume`: the host parser builds padded batches, and the device runs
validate + qc_stats on them (parallel/pipeline.py). That covers a chunk
that fails the proof and everything after it, a trailing partial record, a
file whose head is not uniform, and gzip input. The report is the same on
either route.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from blazeseq_tpu.constants import DEFAULT_BATCH_SIZE
from blazeseq_tpu.fastq.parser import FastqParser, ParserConfig
from blazeseq_tpu.fastq.quality import QualitySchema, parse_schema
from blazeseq_tpu.io.readers import MemoryReader, MmapReader, open_reader

from ..ops.adapter import adapter_content
from ..ops.common import resolve_device, round_up
from ..ops.dedup import (duplication_levels, overrepresented_sequences,
                         read_hashes)
from ..ops.stats import MAX_PHRED, QCAccumulator, zero_stats
from ..ops.uniform_parse import detect_uniform_layout
from ..ops.uniform_qc import uniform_qc
from ..parallel.ingest import OverlappedIngest
from ..parallel.pipeline import build_qc_align_step

# padded read widths round up to this many columns
_WIDTH_UNIT = 128
# run_parser flushes its device-resident totals to the host this often
_FLUSH_EVERY = 64


@dataclass
class QCReport:
    reads: int
    bases: int
    error_reads: int
    gc_fraction: float
    mean_quality: float
    base_counts: np.ndarray  # [5] A C G T other
    per_position_mean_quality: np.ndarray
    qual_hist: np.ndarray
    nw_scores: Optional[np.ndarray] = None  # int32[reads] with align_to
    # FastQC-style per-read distribution panels
    length_hist: Optional[np.ndarray] = None  # [LEN_BINS] reads by length
    gc_hist: Optional[np.ndarray] = None  # [101] reads by GC%
    mean_qual_hist: Optional[np.ndarray] = None  # reads by rounded mean Phred
    # [5, width] A/C/G/T/other counts per position + [width] in-window read
    # count
    per_pos_base_counts: Optional[np.ndarray] = None
    per_pos_count: Optional[np.ndarray] = None
    # adapter panel: {adapter: merged AdapterStats} when adapters= was given
    adapter_stats: Optional[dict] = None
    # duplication panel (track_duplicates=True): levels[k] = distinct
    # sequences seen exactly k times (k=10 means ">= 10"), over the first
    # dup_track_limit reads
    duplication_levels: Optional[np.ndarray] = None
    frac_unique_reads: Optional[float] = None
    # overrepresented sequences: [(prefix bytes <=50bp, count)] for sequences
    # making up > 0.1% of the tracked sample, most frequent first
    overrepresented: Optional[list] = None
    # per-base quality boxplot panel (track_quartiles=True): [5, width]
    # rows = p10, q1, median, q3, p90 per position, and the
    # [MAX_PHRED, width] distribution they derive from
    quality_quartiles: Optional[np.ndarray] = None
    per_pos_qual_hist: Optional[np.ndarray] = None

    def __str__(self) -> str:
        s = ("QCReport(reads=%d, bases=%d, errors=%d, gc=%.4f, meanQ=%.2f"
             % (self.reads, self.bases, self.error_reads, self.gc_fraction,
                self.mean_quality))
        if self.frac_unique_reads is not None:
            s += ", unique=%.1f%%" % (100.0 * self.frac_unique_reads)
        return s + ")"

    def to_dict(self) -> dict:
        """JSON-serializable report: scalars, histograms as lists with their
        zero-count tails trimmed, and the adapter, duplication, quartile and
        alignment panels when enabled."""
        def _trim(a):
            a = np.asarray(a)
            nz = np.flatnonzero(a)
            return a[: int(nz[-1]) + 1].tolist() if nz.size else []

        d = dict(
            reads=int(self.reads), bases=int(self.bases),
            error_reads=int(self.error_reads),
            gc_fraction=round(float(self.gc_fraction), 6),
            mean_quality=round(float(self.mean_quality), 4),
            base_counts=dict(zip("ACGTN", np.asarray(
                self.base_counts).astype(int).tolist())),
            per_position_mean_quality=[
                round(float(x), 3) for x in self.per_position_mean_quality],
            qual_hist=_trim(self.qual_hist),
        )
        if self.length_hist is not None:
            d["length_hist"] = _trim(self.length_hist)
            d["gc_hist"] = _trim(self.gc_hist)
            d["mean_qual_hist"] = _trim(self.mean_qual_hist)
        if self.per_pos_count is not None:
            cnt = np.asarray(self.per_pos_count)
            nz = np.flatnonzero(cnt)
            w = int(nz[-1]) + 1 if nz.size else 0
            d["per_pos_count"] = cnt[:w].astype(int).tolist()
            d["per_pos_base_counts"] = [
                row[:w].astype(int).tolist()
                for row in np.asarray(self.per_pos_base_counts)]
        if self.adapter_stats:
            d["adapters"] = {
                a.decode("ascii", "replace"): dict(
                    reads_with_adapter=int(st.reads_with_adapter),
                    reads_scanned=int(st.reads_scanned),
                    first_occurrence=_trim(st.first_occurrence))
                for a, st in self.adapter_stats.items()}
        if self.duplication_levels is not None:
            d["duplication_levels"] = np.asarray(
                self.duplication_levels).astype(int).tolist()
            d["frac_unique_reads"] = round(float(self.frac_unique_reads), 6)
            d["overrepresented"] = [
                dict(sequence=s.decode("ascii", "replace"), count=c)
                for s, c in (self.overrepresented or [])]
        if self.quality_quartiles is not None:
            w = len(d.get("per_pos_count", self.per_position_mean_quality))
            qq = np.asarray(self.quality_quartiles)[:, :w].astype(int)
            d["quality_quartiles"] = dict(zip(
                ("p10", "q1", "median", "q3", "p90"),
                (row.tolist() for row in qq)))
        if self.nw_scores is not None:
            d["nw_score_mean"] = round(float(np.mean(self.nw_scores)), 4)
        return d


class QCModel:
    """Streaming QC (and optional alignment) engine on one device.

    `device` is where the QC passes run: "cuda" (the default) needs a CUDA
    card and raises without one; "cpu" runs the plain torch versions of the
    kernels and must be asked for by name. Adapters, duplicates, alignment
    and quartiles run on run_file / run_reader / run_parser and are refused
    by run_file_device, as in the reference. `mesh` is accepted and refused
    where it would be used: multi-GPU is a later slice of the port."""

    def __init__(self, quality_schema: str | QualitySchema = "generic",
                 check_ascii: bool = True, check_quality: bool = True,
                 batch_size: int = DEFAULT_BATCH_SIZE,
                 max_read_len: int = 256,
                 align_to: Optional[bytes] = None,
                 adapters: Optional[list] = None,
                 track_duplicates: bool = False,
                 dup_track_limit: int = 200_000,
                 track_quartiles: bool = False,
                 mesh=None, device="cuda"):
        self.device = resolve_device(device, "QCModel")
        # "auto": resolve lazily from the first file's head bytes
        self._auto_schema = quality_schema == "auto"
        if self._auto_schema:
            self.schema = parse_schema("generic")  # placeholder until run
        else:
            self.schema = (quality_schema
                           if isinstance(quality_schema, QualitySchema)
                           else parse_schema(quality_schema))
        self.check_ascii = check_ascii
        self.check_quality = check_quality
        self.batch_size = batch_size
        self.max_read_len = round_up(max_read_len, _WIDTH_UNIT)
        self.align_to = align_to
        # the reference is uploaded once
        self._ref = (None if align_to is None else torch.from_numpy(
            np.frombuffer(bytes(align_to), np.uint8).copy()).to(self.device))
        self.adapters = [bytes(a) for a in adapters] if adapters else None
        # FastQC-style: profile duplication over the first dup_track_limit
        # reads (the device hashes every read; the host counts repeats)
        self.track_duplicates = track_duplicates
        self.dup_track_limit = dup_track_limit
        self.track_quartiles = track_quartiles
        self.mesh = mesh
        self._step = build_qc_align_step(
            check_ascii=check_ascii, check_quality=check_quality,
            with_alignment=align_to is not None,
            qual_hist_2d=track_quartiles)
        # chunks / padded batches each route took in the last pass
        self.tier_chunks = {"uniform": 0, "host": 0}

    def _resolve_auto_schema(self, path) -> None:
        if self._auto_schema:
            from blazeseq_tpu.fastq.quality import detect_quality_schema_file

            self.schema = detect_quality_schema_file(str(path))
            self._auto_schema = False  # one corpus per model instance

    def run_file(self, path, parallelism: int = 4) -> QCReport:
        """QC (and the optional panels) of one FASTQ file, plain or gzip,
        through the host parser and the padded-batch device step."""
        self._resolve_auto_schema(path)
        return self.run_reader(open_reader(path, parallelism=parallelism))

    def run_reader(self, reader) -> QCReport:
        return self.run_parser(self._parser(reader))

    def run_parser(self, parser: FastqParser) -> QCReport:
        if self._auto_schema:
            raise ValueError(
                "quality_schema='auto' needs a path-based entry point "
                "(run_file / run_file_device): a stream cannot be peeked "
                "twice")
        if self.mesh is not None:
            raise NotImplementedError(
                "mesh sharding is not ported yet (ROADMAP Queue 1, "
                "multi-GPU)")
        acc = QCAccumulator()
        # device-resident running total, flushed to the host every
        # _FLUSH_EVERY batches (int32 leaves stay far from overflow)
        dev_total = None
        pending = 0
        scores = [] if self.align_to is not None else None
        ad_totals = ({a: None for a in self.adapters}
                     if self.adapters else None)
        dup_hashes = [] if self.track_duplicates else None
        dup_prefixes = []
        dup_seen = 0
        for pb in parser.padded_batches(self.batch_size,
                                        max_len=self.max_read_len,
                                        pad_records_to=self.batch_size):
            n = int(pb.n_records)
            seq, qual, lengths = self._upload(pb)
            res = self._step(seq, qual, lengths, n, self.schema, self._ref)
            dev_total = (res.stats if dev_total is None
                         else dev_total.merge(res.stats))
            pending += 1
            if pending >= _FLUSH_EVERY:
                acc.add(dev_total)
                dev_total = None
                pending = 0
            if scores is not None:
                scores.append(res.nw_scores[:n])
            if ad_totals is not None:
                for a in self.adapters:
                    ast = adapter_content(seq, lengths, n, adapter_host=a)
                    ad_totals[a] = (ast if ad_totals[a] is None
                                    else ad_totals[a].merge(ast))
            if dup_hashes is not None and dup_seen < self.dup_track_limit:
                take = min(n, self.dup_track_limit - dup_seen)
                dup_hashes.append(read_hashes(seq, lengths, n)[:take])
                # 50 bp representative prefixes for the overrepresented list
                dup_prefixes.append(
                    np.array(pb.seq[:take, : min(50, pb.seq.shape[1])]))
                dup_seen += take
        if dev_total is not None:
            acc.add(dev_total)
        extra = {}
        if scores:
            extra["nw_scores"] = torch.cat(scores).cpu().numpy()
        if ad_totals is not None:
            extra["adapter_stats"] = {a: st.to_numpy()
                                      for a, st in ad_totals.items()
                                      if st is not None}
        if dup_hashes is not None:
            extra.update(self._dup_report(dup_hashes, dup_prefixes))
        return self._report_from_acc(acc, **extra)

    def _upload(self, pb):
        """A padded batch's seq, qual and int32 lengths on the device."""
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                     for a in (pb.seq, pb.qual,
                               np.asarray(pb.lengths, np.int32)))

    def run_file_device(self, path, chunk_mb: int = 256,
                        parallelism: int = 4) -> QCReport:
        """QC of one FASTQ file on the device. Device chunks build the Phred
        histogram in eq-mode over the values seen in the file head; a
        nonzero remainder bin in the report triggers ONE full-bin re-run,
        so the result never depends on the peek."""
        self._hist_his = set()
        rep = self._run_file_device_once(path, chunk_mb, parallelism,
                                         adaptive=True)
        if any(self._hist_overflows(rep, h) for h in self._hist_his):
            self._hist_his = set()
            rep = self._run_file_device_once(path, chunk_mb, parallelism,
                                             adaptive=False)
        return rep

    def _run_file_device_once(self, path, chunk_mb: int = 256,
                              parallelism: int = 4,
                              adaptive: bool = True) -> QCReport:
        """One pass over the file: uniform chunks on the device; anything
        the uniform tier cannot prove through _host_consume (see the module
        docstring). Reads longer than max_read_len are truncated only in
        the per-position panels, as in the reference."""
        if (self.adapters or self.track_duplicates or self.mesh is not None
                or self.align_to is not None or self.track_quartiles):
            raise ValueError(
                "run_file_device covers core QC; use run_file for "
                "adapters/duplicates/alignment/quartiles/mesh")
        p = str(path)
        self._resolve_auto_schema(p)
        self.tier_chunks = {"uniform": 0, "host": 0}
        acc = QCAccumulator()
        if p.endswith(".gz") or p.endswith(".bgz"):
            self._host_consume(self._parser(
                open_reader(p, parallelism=parallelism)), acc)
            return self._report_from_acc(acc)
        reader = MmapReader(p)
        data = reader.as_array()
        if data is None or len(data) == 0:
            self._host_consume(self._parser(reader), acc)
            return self._report_from_acc(acc)
        lay = detect_uniform_layout(data)
        if lay is None or lay.rs > chunk_mb << 19:
            self._host_consume(self._parser(MemoryReader(data)), acc)
            return self._report_from_acc(acc)
        total = len(data)
        csize = max((chunk_mb << 20) // lay.rs, 1) * lay.rs
        # never allocate a chunk larger than the (rs-rounded) input
        csize = min(csize, -(-total // lay.rs) * lay.rs)
        hv = self._adaptive_hist_vals(data) if adaptive else ()
        uqc = self._device_uqc(lay, self.max_read_len, hist_vals=hv)

        # Full-size chunks are read-only slices of the mapping; the device
        # works `depth` chunks behind the dispatch front. A chunk's verdict
        # arrives late: chunks dispatched after a failure are discarded and
        # the host route resumes from the failed chunk's start.
        ing = OverlappedIngest(uqc, csize, row_bytes=lay.rs,
                               device=self.device)
        fail_pos = None

        def consume(ready):
            nonlocal fail_pos
            for meta, (ok, st) in ready:
                if fail_pos is not None:
                    continue
                if bool(ok):
                    acc.add(st)
                    self.tier_chunks["uniform"] += 1
                else:
                    fail_pos = meta  # proof failed: host from this boundary
        pos = 0
        while pos < total and fail_pos is None:
            b = min(pos + csize, total)
            n_valid = (b - pos) // lay.rs * lay.rs
            if n_valid == 0:
                break  # trailing partial record: host tail
            if b - pos == csize:
                consume(ing.feed(data[pos:b], n_valid, meta=pos,
                                 owned=False))
            else:
                buf = ing.acquire()
                buf[: b - pos] = data[pos:b]
                buf[b - pos:] = 0
                consume(ing.feed(buf, n_valid, meta=pos))
            pos += n_valid
        consume(ing.drain())
        # fail_pos and pos are proven record boundaries: every accepted
        # chunk ends at one
        rest = fail_pos if fail_pos is not None else pos
        if rest < total:
            self._host_consume(self._parser(MemoryReader(data[rest:])), acc)
        return self._report_from_acc(acc)

    def _parser(self, reader) -> FastqParser:
        """Structure-only host parser: validation runs on the device, so bad
        records count as error_reads instead of raising."""
        parser = FastqParser(reader, config=ParserConfig())
        parser.quality_schema = self.schema
        return parser

    def _device_uqc(self, lay, width, hist_vals=()):
        """The device step for a layout: one-pass parse + validate + QC
        (ops/uniform_qc.py). `hist_vals` (a host-peeked distinct-phred set)
        selects the eq-mode Phred histogram; the caller re-runs full-bins
        when the accumulated remainder bin is nonzero (_hist_overflows)."""
        def uqc(c, n_valid):
            return uniform_qc(
                c, n_valid, rs=lay.rs, o1=lay.o1, o2=lay.o2, o3=lay.o3,
                width=width, q_lo=int(self.schema.LOWER),
                q_hi=int(self.schema.UPPER), offset=int(self.schema.OFFSET),
                check_ascii=self.check_ascii,
                check_quality=self.check_quality, hist_vals=hist_vals)

        return uqc

    def _adaptive_hist_vals(self, data, head_bytes=1 << 16) -> tuple:
        """Distinct phred values over the corpus head's quality lines
        (lines 4k+3 of the newline grouping), for the eq-mode histogram.
        Returns () (= off) when not profitable or outside the eq-mode
        preconditions; a wrong peek is caught by the remainder bin and only
        costs one full-bin re-run (run_file_device), never exactness."""
        off = int(self.schema.OFFSET)
        lo, hi = int(self.schema.LOWER), int(self.schema.UPPER)
        if not self.check_quality or lo < off:
            return ()
        n_bins_full = min(hi - off, MAX_PHRED - 1) + 1
        head = np.asarray(data[: min(len(data), head_bytes)])
        nl = np.flatnonzero(head == 10)
        k = len(nl) // 4
        if k < 1:
            return ()
        sep_nl = nl[2:4 * k:4]
        qual_nl = nl[3:4 * k:4]
        seen = np.zeros(256, bool)
        for s, e in zip(sep_nl, qual_nl):
            if e > s + 1:
                seen[np.unique(head[s + 1:e])] = True
        bytes_seen = np.flatnonzero(seen)
        if len(bytes_seen) == 0 or bytes_seen.min() < off:
            return ()
        vals = tuple(int(b) - off for b in bytes_seen)
        # profitable and room for the remainder bin
        if max(vals) + 1 >= n_bins_full or len(vals) + 2 >= n_bins_full:
            return ()
        self.__dict__.setdefault("_hist_his", set()).add(vals)
        return vals

    def _hist_overflows(self, report, hist_vals) -> bool:
        """True when a device chunk saw a phred value OUTSIDE the eq-mode
        set: its count landed in the remainder bin (max+1), so the report
        is NOT exact and the caller re-runs with full bins. (The host route
        uses full bins and can legitimately populate that bin; a false
        positive costs a re-run, never exactness.)"""
        if not hist_vals or not self.check_quality:
            return False
        return int(report.qual_hist[max(hist_vals) + 1]) != 0

    def _host_consume(self, parser, acc) -> None:
        """Host route: structure-only host parse into padded batches, then
        validation + stats on the device (parallel/pipeline.py)."""
        for pb in parser.padded_batches(self.batch_size,
                                        max_len=self.max_read_len,
                                        pad_records_to=self.batch_size):
            res = self._step(*self._upload(pb), int(pb.n_records),
                             self.schema)
            acc.add(res.stats)
            self.tier_chunks["host"] += 1

    def _report_from_acc(self, acc, **extra) -> QCReport:
        """The report from the host totals: the core panels, the quartile
        panel when tracked, and the `extra` fields."""
        if acc.total is None:
            acc.add(zero_stats(self.max_read_len, self.track_quartiles))
        t = acc.total
        return QCReport(
            reads=int(t.reads),
            bases=int(t.bases),
            error_reads=int(t.error_reads),
            gc_fraction=acc.gc_fraction(),
            mean_quality=acc.mean_quality(),
            base_counts=np.asarray(t.base_counts),
            per_position_mean_quality=acc.per_position_mean_quality(),
            qual_hist=np.asarray(t.qual_hist),
            length_hist=np.asarray(t.length_hist),
            gc_hist=np.asarray(t.gc_hist),
            mean_qual_hist=np.asarray(t.mean_qual_hist),
            per_pos_base_counts=np.asarray(t.per_pos_base_counts),
            per_pos_count=np.asarray(t.per_pos_count),
            **self._quartile_report(acc),
            **extra,
        )

    @staticmethod
    def _quartile_report(acc) -> dict:
        """quality_quartiles / per_pos_qual_hist report fields (empty when
        the distribution was not tracked)."""
        t = acc.total
        if t is None or t.per_pos_qual_hist is None:
            return {}
        return dict(
            quality_quartiles=acc.per_position_quality_quartiles(),
            per_pos_qual_hist=np.asarray(t.per_pos_qual_hist))

    @staticmethod
    def _dup_report(dup_hashes, dup_prefixes) -> dict:
        """The duplication panel's fields from the sampled hashes (int64
        device tensors holding uint32 values) and 50 bp prefixes."""
        h = (torch.cat(dup_hashes).cpu().numpy().astype(np.uint32)
             if dup_hashes else np.empty((0, 2), np.uint32))
        pfx = (np.concatenate(dup_prefixes)
               if dup_prefixes else np.empty((0, 0), np.uint8))
        levels, frac_unique = duplication_levels(h)
        return dict(duplication_levels=levels, frac_unique_reads=frac_unique,
                    overrepresented=overrepresented_sequences(h, pfx))
