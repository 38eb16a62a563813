"""QCModel: streaming FastQC-style quality control of a FASTQ file
(counterpart of blazeseq_tpu/models/qc.py: the uniform, semi-uniform,
ragged and stream tiers of run_file_device, and the host-parse path).

`run_file(path)` (and `run_reader` / `run_parser`) parses on the host into
padded batches; the device runs validate + QC and, with `align_to`, the
alignment kernel on each batch (parallel/pipeline.py), plus the adapter
scan, the read hashes of the duplication panel and the per-position
quality distribution when asked for. Device totals are flushed to the host
int64 accumulator every 64 batches.

`run_file_device(path)` covers core QC only. It maps a plain FASTQ file and
sends raw byte chunks to the device through the overlapped feed
(parallel/ingest.py); the host adds each chunk's results in int64. Three
tiers, each counted in `tier_chunks`:

* uniform: every record has one layout (read from the file head); one
  pass per rs-aligned chunk proves the layout and computes every QC panel
  (ops/uniform_qc.py);
* semi: one read length with ids of varying width; the host rewrites each
  record's id to a fixed width (native.normalize_semi_uniform) straight
  into the feed's staging buffers, and the uniform pass runs on the
  result;
* ragged: any other layout; chunks are cut at record boundaries found on
  the host (parallel/sharding.py) and one pass per chunk parses, validates
  and computes every panel (ops/ragged_qc.py). The chunk size is the
  caller's `chunk_mb`, up to 256 MiB (the reference caps it at 128 MB):
  the step's sums are int32, and a per-position Phred sum stays exact up
  to 2**28 bytes even for 8-byte records of Phred 63.

The uniform tier hands a chunk that fails its proof, and everything after
it, to the semi tier; the semi tier hands what it cannot take (a proof
failure, from that chunk's original start; a head that is not semi-uniform;
a record larger than half a chunk) to the ragged tier. What the ragged tier
rejects (invalid bytes, from that chunk's start) and the trailing partial
record go through `_host_consume`: the host parser builds padded batches,
and the device runs validate + qc_stats on them (parallel/pipeline.py).

Compressed input (`.gz`, `.bgz`) inflates on the host in a background
thread (io/readers.open_reader) and runs two stream tiers, counted under
the same names: the uniform stream tier (kernel B on rs-aligned chunks of
the inflated stream, each chunk's partial tail carried into the next) when
the 64 KiB head has one layout, else the ragged stream tier (the ragged
kernel on chunks that start at a record boundary, the carry set by the
kernel's `tail_start`). A proof failure hands the rest of the stream, from
the failed chunk's start, to the ragged stream tier; what that tier
rejects and the partial tail go to the host route. There is no semi stream
tier: variable ids in a compressed file take the ragged stream tier, as in
the reference. The report is the same on every route.

The port keeps two routes of its own, with equal reports: a uniform layout
that kernel B refuses on the card (more than 512 stats columns, or odd
records above ~3.9 KB, see ops/uniform_qc.kernel_takes) goes to the ragged
tier (the ragged stream tier for compressed input), where the reference
stays on its uniform kernel; and a chunk that the reference's ragged step
reports as `fallback` stays on the device (the port's ragged kernel has no
slot capacity).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import native, tracing
from ..constants import DEFAULT_BATCH_SIZE
from ..fastq.parser import FastqParser, ParserConfig
from ..fastq.quality import QualitySchema, parse_schema
from ..io.readers import MemoryReader, MmapReader, open_reader
from ..ops.adapter import _adapter_contents
from ..ops.common import resolve_device, round_up
from ..ops.dedup import (_read_hashes_into, duplication_levels,
                         overrepresented_sequences)
from ..ops.ragged_qc import ragged_qc
from ..ops.stats import MAX_PHRED, QCAccumulator, zero_stats
from ..ops.uniform_parse import UniformLayout, detect_uniform_layout
from ..ops.uniform_qc import kernel_takes, uniform_qc
from ..parallel.ingest import OverlappedIngest
from ..parallel.mesh import (DP_AXIS, SP_AXIS, all_gather, axis_index,
                             axis_size, mesh_device, psum_tuple, replicated,
                             shard_batch)
from ..parallel.multihost import _allreduce_stats
from ..parallel.pipeline import _local_record_count, build_qc_align_step
from ..parallel.sharding import find_record_boundary_bytes

# padded read widths round up to this many columns
_WIDTH_UNIT = 128
# run_parser flushes its device-resident totals to the host this often
_FLUSH_EVERY = 64
# run_parser's duplication sample starts with room for this many batches
# (at most dup_track_limit rows) and doubles when full
_DUP_SAMPLE_BATCHES = 64
# the ragged tier's largest chunk: 2**28 bytes hold at most 2**25 records
# with a quality byte, so a per-position Phred sum (at most 63 a record)
# stays inside int32
_RAGGED_MAX_MB = 256
_TIERS = ("uniform", "semi", "ragged", "host")
# the stream tiers read the layout from this much of the decompressed head
_HEAD_BYTES = 1 << 16


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


class _ChainedReader:
    """Reader serving buffered leftover bytes first, then an inner reader
    (hands a partly consumed stream to the next tier or the host parser)."""

    def __init__(self, leftover: bytes, inner):
        self._left = memoryview(leftover)
        self._pos = 0
        self._inner = inner

    def readinto(self, mv) -> int:
        if self._pos < len(self._left):
            n = min(len(mv), len(self._left) - self._pos)
            mv[:n] = self._left[self._pos : self._pos + n]
            self._pos += n
            return n
        return self._inner.readinto(mv)

    def close(self) -> None:
        self._inner.close()


def _gather_blocks(mesh, blocks):
    """Each batch's rows in record order, from this rank's dp row block of
    every batch, with one gather over 'dp' (the blocks of a batch have one
    size on every rank)."""
    rows = all_gather(torch.cat(blocks), mesh.get_group(DP_AXIS))
    per_batch = rows.view(axis_size(mesh, DP_AXIS), -1).split(
        [b.shape[0] for b in blocks], dim=1)
    return [b.reshape(-1) for b in per_batch]


class QCModel:
    """Streaming QC (and optional alignment) engine on one device.

    `device` is where the QC passes run: "cuda" (the default) needs a CUDA
    card and raises without one; "cpu" runs the plain torch versions of the
    kernels and must be asked for by name. Adapters, duplicates, alignment
    and quartiles run on run_file / run_reader / run_parser and are refused
    by run_file_device, as in the reference, and so is `mesh`.

    With `mesh` (parallel/mesh.make_mesh, on `device`'s type) every rank
    parses the whole input and runs the step on its block of each batch
    (batches are padded to a multiple of the mesh's size). On a 1-D mesh
    that is the one-device step on the block's own records, with no
    collective per batch; a dp x sp mesh runs the mesh step, whose stats
    merge inside each batch. The totals, the adapter panel and the
    alignment scores (in record order) merge once, at the end, and the read
    hashes of the duplication panel are taken on whole rows, so every rank
    returns the report of one device."""

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
        self.tier_chunks = dict.fromkeys(_TIERS, 0)

    def _resolve_auto_schema(self, path) -> None:
        if self._auto_schema:
            from ..fastq.quality import detect_quality_schema_file

            self.schema = detect_quality_schema_file(str(path))
            self._auto_schema = False  # one corpus per model instance

    def run_file(self, path, parallelism: int = 4) -> QCReport:
        """QC (and the optional panels) of one FASTQ file, plain or gzip,
        through the host parser and the padded-batch device step."""
        with tracing.span("bs.run_file"):
            self._resolve_auto_schema(path)
            return self.run_reader(open_reader(path,
                                               parallelism=parallelism))

    def run_reader(self, reader) -> QCReport:
        return self.run_parser(self._parser(reader))

    def run_parser(self, parser: FastqParser) -> QCReport:
        if self._auto_schema:
            raise ValueError(
                "quality_schema='auto' needs a path-based entry point "
                "(run_file / run_file_device): a stream cannot be peeked "
                "twice")
        mesh = self.mesh
        step, pad_n, ref = self._step, self.batch_size, self._ref
        sp = False
        if mesh is not None:
            dev = mesh_device(mesh, self.device, "QCModel")
            ref = None if ref is None else ref.to(dev)
            sp = axis_size(mesh, SP_AXIS) > 1
            if sp:
                step = build_qc_align_step(
                    mesh, check_ascii=self.check_ascii,
                    check_quality=self.check_quality,
                    with_alignment=self.align_to is not None,
                    qual_hist_2d=self.track_quartiles)
            pad_n = round_up(pad_n, mesh.size())
        acc = QCAccumulator()
        # device-resident running total, flushed to the host every
        # _FLUSH_EVERY batches (int32 leaves stay far from overflow); the
        # one-device step adds each batch into it, the dp x sp mesh step
        # merges its collectives' result
        dev_total = None
        pending = 0
        scores = [] if self.align_to is not None else None
        counts = []  # records in each batch
        ad_totals = None  # one AdapterStats an adapter, a running total
        # the duplication sample: int64 [rows, 2] hashes on the device,
        # rows [0, dup_seen) filled, and the host's 50 bp prefixes
        dup_hashes = None
        dup_prefixes = []
        dup_seen = 0
        for pb in parser.padded_batches(self.batch_size,
                                        max_len=self.max_read_len,
                                        pad_records_to=pad_n):
            n = int(pb.n_records)
            if mesh is None:
                seq, qual, lengths = self._upload(pb)
                n_step = n
            else:
                seq, qual, lengths = shard_batch(
                    mesh, pb.seq, pb.qual, np.asarray(pb.lengths, np.int32))
                # the mesh step takes the batch's count, the one-device
                # step this block's
                n_step = n if sp else _local_record_count(
                    seq.shape[0], n, axis_index(mesh, DP_AXIS))
            with tracing.span("bs.qc.step"):
                if sp:
                    res = step(seq, qual, lengths, n_step, self.schema, ref)
                    dev_total = (res.stats if dev_total is None
                                 else dev_total.merge(res.stats))
                else:
                    res = step(seq, qual, lengths, n_step, self.schema, ref,
                               out=dev_total)
                    dev_total = res.stats
            pending += 1
            if pending >= _FLUSH_EVERY:
                with tracing.span("bs.qc.accumulate"):
                    acc.add(dev_total)
                dev_total = None
                pending = 0
            if scores is not None:
                scores.append(res.nw_scores)
                counts.append(n)
            if self.adapters:
                rows, lens, n_rows = self._rank_rows(pb, seq, lengths,
                                                     n_step)
                with tracing.span("bs.qc.adapters"):
                    ad_totals = _adapter_contents(rows, lens, n_rows,
                                                  self.adapters,
                                                  out=ad_totals)
            if (self.track_duplicates and n
                    and dup_seen < self.dup_track_limit):
                take = min(n, self.dup_track_limit - dup_seen)
                hseq, hlens = seq, lengths
                if mesh is not None:
                    # whole rows, as the reference's separate pass
                    whole = replicated(mesh)
                    hseq, hlens = whole.local(pb.seq[:take]), whole.local(
                        np.asarray(pb.lengths[:take], np.int32))
                dup_hashes = self._dup_room(dup_hashes, dup_seen + take,
                                            hseq.device)
                # only the sampled rows, straight into the sample
                with tracing.span("bs.qc.hashes"):
                    _read_hashes_into(hseq, hlens, n, dup_hashes, dup_seen,
                                      take)
                # 50 bp representative prefixes for the overrepresented list
                dup_prefixes.append(
                    np.array(pb.seq[:take, : min(50, pb.seq.shape[1])]))
                dup_seen += take
        if dev_total is not None:
            with tracing.span("bs.qc.accumulate"):
                acc.add(dev_total)
        if mesh is not None and not sp and acc.total is not None:
            # each rank summed its own blocks: one exact int64 merge
            merged = QCAccumulator()
            merged.add(_allreduce_stats(acc.total, mesh.get_group(DP_AXIS)))
            acc = merged
        extra = {}
        if scores:
            if mesh is not None:
                scores = _gather_blocks(mesh, scores)
            extra["nw_scores"] = torch.cat(
                [s[:k] for s, k in zip(scores, counts)]).cpu().numpy()
        if ad_totals is not None:
            panels = extra["adapter_stats"] = {}
            for a, st in zip(self.adapters, ad_totals):
                st = (st if mesh is None else psum_tuple(
                    mesh, st, mesh.mesh_dim_names)).to_numpy()
                # an adapter listed twice counts twice, as in the reference
                panels[a] = st if a not in panels else panels[a].merge(st)
        if self.track_duplicates:
            extra.update(self._dup_report(dup_hashes, dup_seen, dup_prefixes))
        return self._report_from_acc(acc, **extra)

    def _rank_rows(self, pb, seq, lengths, n):
        """(rows, lengths, n_records) of the adapter scan on this rank, `n`
        being the step's count: the step's rows without a mesh or on a
        1-D one (the panel sums over the mesh at the end); under 'sp', row
        block r of the mesh's flattened ranks, uploaded at full width."""
        mesh = self.mesh
        if mesh is None or axis_size(mesh, SP_AXIS) == 1:
            return seq, lengths, n
        m = pb.seq.shape[0] // mesh.size()
        lo = m * (axis_index(mesh, DP_AXIS) * axis_size(mesh, SP_AXIS)
                  + axis_index(mesh, SP_AXIS))
        whole = replicated(mesh)
        return (whole.local(pb.seq[lo:lo + m]),
                whole.local(np.asarray(pb.lengths[lo:lo + m], np.int32)),
                max(0, min(n - lo, m)))

    def _upload(self, pb):
        """A padded batch's seq, qual and int32 lengths on the device."""
        with tracing.span("bs.qc.upload"):
            return tuple(
                torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                for a in (pb.seq, pb.qual, np.asarray(pb.lengths, np.int32)))

    def run_file_device(self, path, chunk_mb: int = 256,
                        parallelism: int = 4) -> QCReport:
        """QC of one FASTQ file, plain or compressed, on the device (see
        the module docstring). Uniform-tier chunks of a plain file build the
        Phred histogram in eq-mode over the values seen in the file head; a
        nonzero remainder bin in the report triggers ONE full-bin re-run, so
        the result never depends on the peek. The semi and ragged tiers and
        both stream tiers take full bins: their kernels build every bin
        whatever the set, so a peek would buy them nothing and cost a second
        pass over the file whenever it missed a value (a stream cannot be
        read twice without inflating it again)."""
        with tracing.span("bs.run_file_device"):
            self._hist_his = set()
            rep = self._run_file_device_once(path, chunk_mb, parallelism,
                                             adaptive=True)
            if any(self._hist_overflows(rep, h) for h in self._hist_his):
                # the whole first pass is thrown away: what it kept of
                # the bytes it fed
                tracing.count("qc.reruns")
                tracing.count(
                    "qc.discarded_bytes",
                    tracing.request_count("qc.dispatched_bytes")
                    - tracing.request_count("qc.discarded_bytes"))
                self._hist_his = set()
                rep = self._run_file_device_once(path, chunk_mb, parallelism,
                                                 adaptive=False)
            return rep

    def _run_file_device_once(self, path, chunk_mb: int = 256,
                              parallelism: int = 4,
                              adaptive: bool = True) -> QCReport:
        """One pass over the file through the tiers of the module
        docstring. Reads longer than max_read_len are truncated only in the
        per-position panels, as in the reference."""
        if (self.adapters or self.track_duplicates or self.mesh is not None
                or self.align_to is not None or self.track_quartiles):
            raise ValueError(
                "run_file_device covers core QC; use run_file for "
                "adapters/duplicates/alignment/quartiles/mesh")
        p = str(path)
        self._resolve_auto_schema(p)
        self.tier_chunks = dict.fromkeys(_TIERS, 0)
        acc = QCAccumulator()
        if p.endswith(".gz") or p.endswith(".bgz"):
            self._run_stream_device(p, chunk_mb, parallelism, acc)
            return self._report_from_acc(acc)
        reader = MmapReader(p)
        data = reader.as_array()
        if data is None or len(data) == 0:
            self._host_consume(self._parser(reader), acc)
            return self._report_from_acc(acc)
        with tracing.span("bs.qc.route"):
            lay = detect_uniform_layout(data)
        if lay is None or lay.rs > chunk_mb << 19:
            # semi-uniform tier first; it hands what it declines to the
            # general ragged tier
            self._run_normalized_mmap(data, chunk_mb, acc)
            return self._report_from_acc(acc)
        if not self._kernel_takes(lay.rs, lay.seq_len):
            # the port's own route: the ragged kernel takes any layout
            self._run_ragged_mmap(data, chunk_mb, acc)
            return self._report_from_acc(acc)
        total = len(data)
        csize = max((chunk_mb << 20) // lay.rs, 1) * lay.rs
        # never allocate a chunk larger than the (rs-rounded) input
        csize = min(csize, -(-total // lay.rs) * lay.rs)
        with tracing.span("bs.qc.route"):
            hv = self._adaptive_hist_vals(data) if adaptive else ()
        uqc = self._device_uqc(lay, self.max_read_len, hist_vals=hv)

        # Every chunk is a read-only slice of the mapping, the short last
        # one cut to its whole records; the device works `depth` chunks
        # behind the dispatch front. A chunk's verdict arrives late: chunks
        # dispatched after a failure are discarded and the next tier
        # resumes from the failed chunk's start.
        ing = OverlappedIngest(uqc, csize, row_bytes=lay.rs,
                               device=self.device)
        fail_pos = None

        def consume(ready):
            nonlocal fail_pos
            for (at, nv), (ok, st) in ready:
                if fail_pos is not None:
                    tracing.count("qc.discarded_bytes", nv)
                    continue
                with tracing.span("bs.qc.accumulate"):
                    ok = bool(ok)
                    if ok:
                        acc.add(st)
                if ok:
                    self.tier_chunks["uniform"] += 1
                else:
                    fail_pos = at  # proof failed: next tier from here
                    tracing.count("qc.failed_proofs")
                    tracing.count("qc.discarded_bytes", nv)
        pos = 0
        while pos < total and fail_pos is None:
            b = min(pos + csize, total)
            n_valid = (b - pos) // lay.rs * lay.rs
            if n_valid == 0:
                break  # trailing partial record: host tail
            tracing.count("qc.dispatched_bytes", n_valid)
            consume(ing.feed(data[pos:pos + n_valid], n_valid,
                             meta=(pos, n_valid), owned=False))
            pos += n_valid
        consume(ing.drain())
        # fail_pos and pos are proven record boundaries: every accepted
        # chunk ends at one
        if fail_pos is not None:
            # the head looked uniform and the rest is not (or holds invalid
            # bytes): the semi tier, then the ragged tier, then the host
            # route take the remainder
            self._run_normalized_mmap(data[fail_pos:], chunk_mb, acc)
        elif pos < total:
            self._host_consume(self._parser(MemoryReader(data[pos:])), acc)
        return self._report_from_acc(acc)

    def _kernel_takes(self, rs: int, seq_len: int) -> bool:
        """Whether kernel B takes records of `rs` bytes on this model's
        device (the plain version on the CPU takes every layout)."""
        return self.device.type != "cuda" or kernel_takes(
            rs, min(seq_len, self.max_read_len))

    @staticmethod
    def _peek_semi_uniform(data, head_bytes=1 << 16, margin=16):
        """(L, idw) for the semi-uniform tier from a host peek at the
        corpus head: fixed seq/qual length L, bare '+' separators, id text
        up to idw bytes (max observed + margin). A sizing hint only: the
        normalizer re-checks every record and the device proof re-verifies
        every produced chunk. None when the head is not semi-uniform (mixed
        lengths, '+' with text, malformed)."""
        head = np.asarray(data[: min(len(data), head_bytes)])
        nl = np.flatnonzero(head == 10)
        k = len(nl) // 4
        if k < 1:
            return None
        id_nl = nl[0:4 * k:4]
        seq_nl = nl[1:4 * k:4]
        sep_nl = nl[2:4 * k:4]
        qual_nl = nl[3:4 * k:4]
        starts = np.empty(k, np.int64)
        starts[0] = 0
        starts[1:] = qual_nl[:-1] + 1
        L = int(seq_nl[0] - id_nl[0] - 1)
        if L <= 0:
            return None
        ok = head[starts] == ord("@")
        ok &= (seq_nl - id_nl - 1) == L
        ok &= (sep_nl - seq_nl) == 2
        ok &= head[np.minimum(seq_nl + 1, len(head) - 1)] == ord("+")
        ok &= (qual_nl - sep_nl - 1) == L
        if not ok.all():
            return None
        return L, int((id_nl - starts - 1).max()) + margin

    def _run_normalized_mmap(self, data, chunk_mb: int, acc) -> None:
        """Semi-uniform tier: fixed read length, ids of varying width. The
        host rewrites each record's id line to a fixed width (trailing
        spaces; QC reads no id byte) straight into the feed's staging
        buffers, and kernel B runs on the normalized chunks.

        The device proof re-verifies every produced chunk; a failure hands
        the rest, from that chunk's ORIGINAL start offset, to the ragged
        tier. A normalizer stop mid-file re-peeks: a wider id on the same
        read length widens idw, a new read length restarts with that
        block's layout, and no progress ends the tier. A head that is not
        semi-uniform, a record larger than half a chunk and a normalized
        layout that kernel B refuses on the card leave the rest to the
        ragged tier too."""
        with tracing.span("bs.qc.route"):
            peek = self._peek_semi_uniform(data)
        total = len(data)
        pos = 0
        while peek is not None and pos < total:
            L, idw = peek
            rs = idw + 2 * L + 6
            if rs > (chunk_mb << 19) or not self._kernel_takes(rs, L):
                break
            lay = UniformLayout(rs=rs, o1=idw + 1, o2=idw + 2 + L,
                                o3=idw + 4 + L)
            uqc = self._device_uqc(lay, self.max_read_len)
            csize = max((chunk_mb << 20) // rs, 1) * rs
            # never more rows than the rest of the file can fill: every
            # source record holds at least 2L + 6 bytes
            csize = min(csize, ((total - pos) // (2 * L + 6) + 1) * rs)
            ing = OverlappedIngest(uqc, csize, row_bytes=rs,
                                   device=self.device)
            fail_orig = None

            def consume(ready):
                nonlocal fail_orig
                for (at, nv), (ok, st) in ready:
                    if fail_orig is not None:
                        tracing.count("qc.discarded_bytes", nv)
                        continue
                    with tracing.span("bs.qc.accumulate"):
                        ok = bool(ok)
                        if ok:
                            acc.add(st)
                    if ok:
                        self.tier_chunks["semi"] += 1
                    else:
                        fail_orig = at  # the chunk's ORIGINAL start
                        tracing.count("qc.failed_proofs")
                        tracing.count("qc.discarded_bytes", nv)
            stalled = False
            while pos < total and fail_orig is None:
                buf = ing.acquire()
                with tracing.span("bs.feed.fill"):
                    nrec, consumed = native.normalize_semi_uniform(
                        data, pos, buf, idw, L)
                if nrec == 0:
                    stalled = True
                    break
                tracing.count("qc.dispatched_bytes", nrec * rs)
                consume(ing.feed(buf, nrec * rs, meta=(pos, nrec * rs)))
                pos = consumed
            consume(ing.drain())
            if fail_orig is not None:
                pos = fail_orig
                break  # rejected on the device: the rest leaves this tier
            if not stalled or pos >= total:
                break
            with tracing.span("bs.qc.route"):
                peek = self._peek_semi_uniform(data[pos:])
            if peek is None:
                break
            L2, idw2 = peek
            if L2 == L and idw2 <= idw:
                break  # no progress possible: stop re-peeking
            # same L: an id outgrew the bound, keep the wider of the two;
            # new L: a block boundary, restart with its layout
            peek = (L2, max(idw2, idw) if L2 == L else idw2)
        if pos < total:
            self._run_ragged_mmap(data[pos:], chunk_mb, acc)

    def _device_rqc(self, c, n_valid):
        """The ragged-layout device step: parse + validate + QC of a chunk
        whose header widths and read lengths vary per record
        (ops/ragged_qc.py), with full-bin histograms."""
        return ragged_qc(
            c, n_valid, width=self.max_read_len,
            q_lo=int(self.schema.LOWER), q_hi=int(self.schema.UPPER),
            offset=int(self.schema.OFFSET), check_ascii=self.check_ascii,
            check_quality=self.check_quality)

    def _run_ragged_mmap(self, data, chunk_mb: int, acc) -> None:
        """Ragged tier: chunks cut at record boundaries by a host resync
        (parallel/sharding.find_record_boundary_bytes), so every chunk is
        independent and the feed overlaps as on the uniform tier. The
        device re-proves each chunk (validation, and a tail at the chunk's
        end unless it is the file's last); a rejected chunk, a wrong host
        cut included, hands the rest from its start to the host route, as
        does the last chunk's partial tail."""
        K = 2 * self.max_read_len
        total = len(data)
        chunk_mb = min(chunk_mb, _RAGGED_MAX_MB)
        csize = max((chunk_mb << 20) // K, 1) * K
        csize = min(csize, -(-total // K) * K)
        ing = OverlappedIngest(self._device_rqc, csize, device=self.device)
        fail_pos = None  # the host route takes over from this byte offset

        def consume(ready):
            nonlocal fail_pos
            for (pos_m, nv_m, last), r in ready:
                if fail_pos is not None:
                    tracing.count("qc.discarded_bytes", nv_m)
                    continue
                with tracing.span("bs.qc.accumulate"):
                    tail = int(r.tail_start)
                    good = bool(r.ok) and not bool(r.fallback) \
                        and tail > 0 and (tail == nv_m or last)
                    if good:
                        acc.add(r.stats)
                if not good:
                    fail_pos = pos_m
                    tracing.count("qc.failed_proofs")
                    tracing.count("qc.discarded_bytes", nv_m)
                    continue
                self.tier_chunks["ragged"] += 1
                if last and tail < nv_m:
                    fail_pos = pos_m + tail  # the file's partial tail

        pos = 0
        while pos < total and fail_pos is None:
            cut = min(pos + csize, total)
            if cut < total:
                with tracing.span("bs.feed.fill"):
                    # the resync scans FORWARD: probe from a little before
                    # the capacity limit and take the first boundary it
                    # proves, backing off further for records longer than
                    # the window (a short probe keeps the pure-Python scan
                    # cheaper than the chunk copy). A cut past pos + csize
                    # cannot fit the staging buffer; no provable boundary
                    # leaves the rest to the host route.
                    back = 4096
                    while True:
                        cut = find_record_boundary_bytes(
                            data, max(pos + 1, pos + csize - back),
                            probe=back + 8192)
                        if cut <= pos + csize or back >= csize:
                            break
                        back *= 4
                if cut <= pos or cut > pos + csize:
                    break
            nv = cut - pos
            buf = ing.acquire()
            with tracing.span("bs.feed.fill"):
                buf[:nv] = data[pos:cut]
                buf[nv:] = 0
            tracing.count("qc.dispatched_bytes", nv)
            consume(ing.feed(buf, nv, meta=(pos, nv, cut >= total)))
            pos = cut
        consume(ing.drain())
        if fail_pos is not None:
            pos = fail_pos
        if pos < total:
            self._host_consume(self._parser(MemoryReader(data[pos:])), acc)

    def _run_stream_device(self, path, chunk_mb: int, parallelism: int,
                           acc) -> None:
        """Uniform stream tier: compressed input inflates on the host
        (io/readers.open_reader: a BGZF block pool, or parallel marker
        inflate of one gzip stream, in a background thread) into rs-aligned
        chunks that kernel B takes as on the uniform mmap tier. A head that
        is not uniform, a record larger than half a chunk and a layout that
        kernel B refuses on the card go to the ragged stream tier; so does
        the rest of the stream after a chunk fails its proof. The trailing
        partial record goes to the host route."""
        reader = open_reader(path, parallelism=parallelism)
        try:
            head = bytearray()
            scratch = bytearray(_HEAD_BYTES)
            head_eof = False
            while len(head) < _HEAD_BYTES:
                n = reader.readinto(memoryview(scratch))
                if n == 0:
                    head_eof = True
                    break
                head += scratch[:n]
            head = bytes(head)
            with tracing.span("bs.qc.route"):
                lay = detect_uniform_layout(head)
            if (lay is None or lay.rs > chunk_mb << 19
                    or not self._kernel_takes(lay.rs, lay.seq_len)):
                self._run_ragged_stream(head, reader, chunk_mb, acc)
            else:
                self._run_uniform_stream(lay, head, head_eof, reader,
                                         chunk_mb, acc)
        finally:
            reader.close()

    def _run_uniform_stream(self, lay, head: bytes, head_eof: bool, reader,
                            chunk_mb: int, acc) -> None:
        """The uniform stream tier's chunk loop (see _run_stream_device)
        from the peeked `head` on. Each buffer holds `carry` bytes copied
        from the previous chunk's tail (past its last whole record), then
        fresh stream bytes. A chunk's verdict arrives `depth` dispatches
        late; on a failure the unconsumed stream is the failed chunk's whole
        buffer, then the fresh bytes of every later chunk, in flight or not
        yet dispatched (keep_bytes=True keeps those buffers out of rotation
        until their results are delivered)."""
        csize = max((chunk_mb << 20) // lay.rs, 1) * lay.rs
        if head_eof:
            # the whole stream is in the head: no chunk larger than it
            csize = max(min(csize, -(-len(head) // lay.rs) * lay.rs), lay.rs)
        ing = OverlappedIngest(self._device_uqc(lay, self.max_read_len),
                               csize, keep_bytes=True, row_bytes=lay.rs,
                               device=self.device)
        pending = deque()  # (buffer, fill, carry) of each chunk in flight
        rest = None  # on a failure: the stream bytes the device did not take

        def consume(ready):
            nonlocal rest
            for nv, (ok, st) in ready:
                b, f, c = pending.popleft()
                if rest is not None:
                    tracing.count("qc.discarded_bytes", nv)
                    continue
                with tracing.span("bs.qc.accumulate"):
                    ok = bool(ok)
                    if ok:
                        acc.add(st)
                if ok:
                    self.tier_chunks["uniform"] += 1
                else:
                    rest = [bytes(b[:f])] + [bytes(pb[pc:pf])
                                             for pb, pf, pc in pending]
                    tracing.count("qc.failed_proofs")
                    tracing.count("qc.discarded_bytes", nv)
        buf = ing.acquire()
        fill, carry, eof = len(head), 0, head_eof  # the head is fresh bytes
        buf[:fill] = np.frombuffer(head, np.uint8)
        while True:
            while fill < csize and not eof:
                n = reader.readinto(memoryview(buf)[fill:])
                if n == 0:
                    eof = True
                fill += n
            n_valid = fill // lay.rs * lay.rs
            if n_valid == 0:
                break  # a partial record ends the stream
            buf[fill:] = 0
            pending.append((buf, fill, carry))
            tracing.count("qc.dispatched_bytes", n_valid)
            consume(ing.feed(buf, n_valid, meta=n_valid))
            rem = fill - n_valid
            if rest is not None or (eof and rem == 0):
                buf = None  # dispatched: nothing of it is left over
                break
            nbuf = ing.acquire()
            nbuf[:rem] = buf[n_valid:fill]
            buf, fill, carry = nbuf, rem, rem
        consume(ing.drain())
        if rest is not None:
            if buf is not None:
                rest.append(bytes(buf[carry:fill]))
            # the failed chunk starts at a record boundary: every accepted
            # chunk ends at one
            self._run_ragged_stream(
                b"", _ChainedReader(b"".join(rest), reader), chunk_mb, acc)
        elif buf is not None and fill:
            # the partial tail, chained to the stream as on the other tiers
            self._host_consume(self._parser(
                _ChainedReader(bytes(buf[:fill]), reader)), acc)

    def _run_ragged_stream(self, head: bytes, reader, chunk_mb: int,
                           acc) -> None:
        """Ragged stream tier: the decompressed stream, from `head` on,
        fills chunks of up to chunk_mb (capped as on the ragged mmap tier)
        that start at a record boundary. The ragged kernel parses, validates
        and QCs each chunk and reports where its last whole record ends; the
        bytes past it open the next chunk. A rejected chunk, or one with no
        whole record, hands its bytes and the rest of the stream to the host
        route, as does the stream's partial tail. Chunks upload through
        pinned staging (OverlappedIngest with depth 0, so each result
        returns at once); the reader's inflate thread runs meanwhile."""
        K = 2 * self.max_read_len
        csize = max((min(chunk_mb, _RAGGED_MAX_MB) << 20) // K, 1) * K
        fill = len(head)
        if fill > csize:
            # a head larger than a chunk (a tiny chunk_mb, a wide window)
            self._host_consume(self._parser(_ChainedReader(head, reader)),
                               acc)
            return
        buf = native.aligned_empty(csize)
        buf[:fill] = np.frombuffer(head, np.uint8)
        ing = None
        eof = False
        while True:
            while fill < csize and not eof:
                n = reader.readinto(memoryview(buf)[fill:csize])
                if n == 0:
                    eof = True
                fill += n
            if fill == 0:
                break
            if ing is None:
                if eof:
                    # the whole stream fits in one chunk: no larger chunk
                    csize = max(-(-fill // K) * K, K)
                ing = OverlappedIngest(self._device_rqc, csize, depth=0,
                                       device=self.device)
            buf[fill:csize] = 0
            tracing.count("qc.dispatched_bytes", fill)
            ((_, r),) = ing.feed(buf[:csize], fill, owned=False)
            with tracing.span("bs.qc.accumulate"):
                tail = int(r.tail_start)
                good = bool(r.ok) and not bool(r.fallback) and tail > 0
                if good:
                    acc.add(r.stats)
            if not good:
                # this chunk and the rest go to the host route
                tracing.count("qc.failed_proofs")
                tracing.count("qc.discarded_bytes", fill)
                break
            self.tier_chunks["ragged"] += 1
            fill -= tail
            buf[:fill] = buf[tail:tail + fill]
            if eof and fill == 0:
                break
        if fill:
            self._host_consume(self._parser(
                _ChainedReader(bytes(buf[:fill]), reader)), acc)

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
        validation + stats on the device (parallel/pipeline.py), added
        into a device-resident total that goes to `acc` every
        _FLUSH_EVERY batches."""
        total, pending = None, 0
        for pb in parser.padded_batches(self.batch_size,
                                        max_len=self.max_read_len,
                                        pad_records_to=self.batch_size):
            seq, qual, lengths = self._upload(pb)
            with tracing.span("bs.qc.step"):
                total = self._step(seq, qual, lengths, int(pb.n_records),
                                   self.schema, out=total).stats
            pending += 1
            if pending >= _FLUSH_EVERY:
                with tracing.span("bs.qc.accumulate"):
                    acc.add(total)
                total, pending = None, 0
            self.tier_chunks["host"] += 1
        if total is not None:
            with tracing.span("bs.qc.accumulate"):
                acc.add(total)

    def _report_from_acc(self, acc, **extra) -> QCReport:
        """The report from the host totals: the core panels, the quartile
        panel when tracked, and the `extra` fields."""
        with tracing.span("bs.qc.report"):
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

    def _dup_room(self, buf, need, device):
        """The duplication sample with room for `need` rows: made at the
        first tracked batch for min(dup_track_limit, _DUP_SAMPLE_BATCHES
        batches) rows, doubled (one copy) when full."""
        size = 0 if buf is None else buf.shape[0]
        if need <= size:
            return buf
        rows = min(self.dup_track_limit, max(
            need, 2 * size, _DUP_SAMPLE_BATCHES * self.batch_size))
        grown = torch.empty((rows, 2), dtype=torch.int64, device=device)
        if size:
            grown[:size] = buf
        return grown

    @staticmethod
    def _dup_report(dup_hashes, dup_seen, dup_prefixes) -> dict:
        """The duplication panel's fields from the sample's first
        `dup_seen` rows (int64 on the device holding uint32 values; None
        for none) and the 50 bp prefixes, in one device-to-host copy."""
        with tracing.span("bs.qc.report"):
            h = (dup_hashes[:dup_seen].cpu().numpy().astype(np.uint32)
                 if dup_hashes is not None
                 else np.empty((0, 2), np.uint32))
            pfx = (np.concatenate(dup_prefixes)
                   if dup_prefixes else np.empty((0, 0), np.uint8))
            levels, frac_unique = duplication_levels(h)
            return dict(duplication_levels=levels,
                        frac_unique_reads=frac_unique,
                        overrepresented=overrepresented_sequences(h, pfx))
