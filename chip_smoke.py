"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--seed N]

Builds the port's CUDA kernels from blazeseq_tpu_torch/csrc (one nvcc per
source, all started together), holds each kernel against its plain torch
version on the card (the ragged kernels on their edge cases and a 256 MiB
chunk of the ragged corpus below; the alignment variant kernel in each of
its five modes at the example's and the QC batch's shapes and on edge
batches, with two score sets; the padded-batch panel kernels qc_stats,
adapter_content and read_hashes at run_file's 4,096 x 256 batch, qc_stats
also at 32,768 x 1,024 with the quartile leaf, and on edge batches, with
qc_stats' and the multi-adapter scan's running totals and FastQC's six
adapters in one launch; the device-parse kernels of csrc/parse.cu on
DEVICE_PARSE_EDGE_CASES, on MANY_TILE_CASES (1,024 tiles and more, at
three views off 16-byte alignment, 20 runs each, so that the tiles'
look-back meets contention), a 256 MiB ragged chunk at 3,121,343 x 300
and a 256 MiB uniform one at 150 columns; the merge kernel of
csrc/merge.cu on MERGE_EDGE_CASES, MERGE_CARD_CASES and the first batch
pair of the merge mates; the CLI ops' kernels of csrc/trim.cu, demux.cu,
tiles.cu and kmer.cu on CLI_OP_EDGE_CASES, the first reads of the 1M-read
file as the CLI pads them and a 32,768 x 1,024 batch, the tile sums also
beside their one PyTorch call, torch.mm of the one-hot tile matrix, and
each trim mode and the tile sums shown to run one kernel a call and no
fill), then
drives the port's paths, each with the launch counts set to 0 just before
it and read just after, and with no plain torch version of a host-route,
device-parse, merge or CLI op kernel (ops/nw.py's wavefronts,
qc_stats_torch, adapter_content_torch, read_hashes_torch,
raw_stream_qc_torch, newline_positions_torch, record_offsets_torch,
gather_padded_torch, count_records_torch, merge_pairs_torch, the trim
modes' *_torch, demux_assign_torch, per_tile_qual_sums_torch,
kmer_counts_torch) allowed a CUDA tensor, in this process or in the ranks
it spawns:

* QCModel(device="cuda").run_file_device over a 2 GiB uniform FASTQ file
  and a 1 GiB quality-binned one, each checked panel by panel against an
  independent numpy oracle;
* run_file_device over a 1 GiB semi-uniform file (150 bp reads, ids of
  varying width) and the 1 GiB ragged file (reads of 35-300 bp, ids of
  10-60 bytes), every chunk on the semi and the ragged tier, each against
  the numpy oracle and against run_file (the host route) on the same file;
* run_file_device over compressed input: a 1 GiB uniform FASTQ as one
  gzip member (level 1, pigz's layout; the uniform stream tier) and the
  1 GiB ragged file as BGZF (the ragged stream tier), each against the
  numpy oracle and against run_file on the same file, with the inflate
  alone timed beside them;
* its fallback route (a mid-file quality error and a trailing partial
  record) against the same call on the CPU;
* NWAligner on 1M reads x 40 bp against a 40 bp reference in batches of
  65,536, the first 2,000 scores against the numpy twin; then the same in
  each of its five other mode x gap combinations (local, semi-global, and
  the three affine-gap forms: csrc/nw.cu's variant kernel);
* QCModel(align_to=..., adapters, duplicates, quartiles).run_file on 1M
  reads x 150 bp: core panels against the oracle, 2,000 alignment scores
  against the numpy twin, and every panel of a 20,000-read prefix against
  the same call on the CPU;
* the device-parse API (raw_stream_qc, count_records_device,
  parse_fastq_device: the scan kernel and every device-parse kernel) over
  the 1 GiB ragged FASTQ in 256 MiB chunks, against the host parser and
  the generator;
* the command line (python -m blazeseq_tpu_torch: stats, stats --device,
  trim in three modes, demux, merge, tiles) in-process on the card over
  the 1M-read file and 250,000 read pairs, against the host twins (one
  launch a batch of each command's kernel: trim's mode, demux_assign,
  merge_pairs a batch pair, the tile sums), and on 20,000-read prefixes
  against the same commands on the CPU;
* the analysis API as the reference's examples/analysis_panels.py drives
  it (bwa_trim, then kmer_counts before and after) over the 1M-read file
  in batches of 65,536, each batch's trim against bwa_trim_torch on the
  CPU and its 4-mers before and after against a numpy oracle;
* the mesh layer on torch.distributed. NCCL takes one rank a card, so a
  1-rank NCCL mesh runs in this process: QCModel(mesh=...).run_file with
  the options above, against that path's single-device report, and
  build_uniform_qc_step(mesh) on a 256 MiB chunk, against the no-mesh
  step. Then ranks that this script spawns as processes of their own
  (--mesh-worker) share the card in gloo groups: run_multihost_qc on 2
  ranks over the 1M-read file (against one process and the oracle), the
  2 x 2 build_qc_align_step with alignment on a 32,768 x 256 batch
  (against the no-mesh step) and the 2-rank build_ragged_qc_step over
  the 1 GiB ragged file in 512 MiB spans (against run_file_device's
  report); their launch counts are added to the path's.

Every phase raises on failure. The second-to-last lines are the kernels'
JSON record and the card's name and power limit; the last line is the
device JSON. Needs a CUDA card: without one it exits nonzero and prints no
result.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import mmap
import os
import re
import shutil
import struct
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np

READ_LEN = 150
# fixed-width Illumina-style header; the record index fills the digit runs
HEADER = b"@A00123:8:H7GKLDSXX:1:1101:00000:0000000 1:N:0:1"
_DIGIT_RUNS = ((HEADER.index(b":00000:") + 1, 5),  # (first column, width)
               (HEADER.index(b":0000000 ") + 1, 7))
RS = len(HEADER) + 1 + READ_LEN + 3 + READ_LEN + 1
BLOCK_RECORDS = 1 << 18
NOVASEQ_BINS = np.array([2, 12, 23, 37])
NOVASEQ_EDGES = np.array([7, 18, 30])
# byte -> base for 256 uniform draws: mostly ACGT, some lower case and N
_SEQ_LUT = np.frombuffer((b"ACGT" * 62) + b"acgt" + b"NNNN", np.uint8)
# draw -> base class 0..4 (A C G T other); find() gives -1 for N
_CLASS_LUT = np.array([b"ACGT".find(bytes([c & 0xDF])) % 5
                       for c in _SEQ_LUT], np.int32)
_PHRED_LUT = NOVASEQ_BINS[np.searchsorted(NOVASEQ_EDGES, np.arange(64))]

KERNEL_B_SOURCE = "blazeseq_tpu_torch/csrc/uniform_qc.cu"
KERNEL_A_SOURCE = "blazeseq_tpu_torch/csrc/validate.cu"
KERNEL_NW_SOURCE = "blazeseq_tpu_torch/csrc/nw.cu"
KERNEL_SCAN_SOURCE = "blazeseq_tpu_torch/csrc/scan.cu"
KERNEL_RAGGED_SOURCE = "blazeseq_tpu_torch/csrc/ragged_qc.cu"
KERNEL_QC_STATS_SOURCE = "blazeseq_tpu_torch/csrc/qc_stats.cu"
KERNEL_ADAPTER_SOURCE = "blazeseq_tpu_torch/csrc/adapter.cu"
KERNEL_HASH_SOURCE = "blazeseq_tpu_torch/csrc/dedup.cu"
KERNEL_MERGE_SOURCE = "blazeseq_tpu_torch/csrc/merge.cu"
KERNEL_TRIM_SOURCE = "blazeseq_tpu_torch/csrc/trim.cu"
KERNEL_DEMUX_SOURCE = "blazeseq_tpu_torch/csrc/demux.cu"
KERNEL_TILES_SOURCE = "blazeseq_tpu_torch/csrc/tiles.cu"
KERNEL_KMER_SOURCE = "blazeseq_tpu_torch/csrc/kmer.cu"
# the upstream nw_gpu example: 1M reads x 40 bp against a 40 bp reference
NW_READS = 1_000_000
NW_READ_LEN = 40
NW_BATCH = 65536
NW_REFERENCE = b"GATTACAGATTACAGATTACAGATTACAGATTACAGATTA"
ADAPTER = b"AGATCGGAAGAG"
ALIGN_READS = 1_000_000
ALIGN_PREFIX_READS = 20_000
TWIN_SAMPLE = 2_000
# the planted corpus varies the tile field over TILES and starts every read
# with one of DEMUX_BARCODES (some with an error, some replaced by noise)
TILES = (1101, 1102, 2101, 2102)
_TILE_COL = HEADER.index(b":1101:") + 1
DEMUX_BARCODES = (b"ACGTACGT", b"TTGGCCAA", b"GATTACAG", b"CAGTCAGT")
# device_parse: a ragged corpus shaped like adapter-trimmed Illumina output
RAGGED_BYTES = 1 << 30
RAGGED_LEN = (35, 300)  # read lengths, inclusive
RAGGED_ID = (10, 60)  # id widths after the '@', inclusive
RAGGED_MIN_RECORD = RAGGED_ID[0] + 2 * RAGGED_LEN[0] + 6
_ID_LUT = np.frombuffer(b"ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789:_.-", np.uint8)
PARSE_CHUNK = 256 << 20
# QCModel's default stats window (max_read_len)
QC_WIDTH = 256
# the mesh paths: the 2 x 2 mesh's padded batch, the bytes of the ragged
# corpus the 2-rank ragged step takes at once (a shard per rank, each at
# most half), and the seconds a spawned rank may run
MESH_BATCH = 32768
MESH_WIDTH = 256
MESH_SPAN = 512 << 20
MESH_TIMEOUT = 300
# run_file_device(semi): 150 bp reads under Illumina-style ids whose tile,
# x and y fields are not zero-padded
SEMI_BYTES = 1 << 30
GZIP_BYTES = 1 << 30  # the uniform corpus of the gzip path, before inflate
GZIP_BLOCK = 1 << 20  # the span each thread deflates (pigz's layout)
BGZF_PAYLOAD = 65280  # bytes a BGZF block holds (io/writers.BGZFWriter)
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")
SEMI_PREFIX = b"@A00123:8:H7GKLDSXX:1:"
SEMI_SUFFIX = b" 1:N:0:1"
# merge: 250,000 pairs from 200 bp fragments, R1 = the first 150 bp, R2 =
# the reverse complement of the last 150
MATE_PAIRS = 250_000
FRAG_LEN = 200
MATE_HEADER = b"@P0000000/1"
_COMP_LUT = np.frombuffer(b"TGCA", np.uint8)  # complement of draws 0..3
# Bounds (the least time the card could take for a kernel's work): the
# bytes it must move (each input read once, each output written once) over
# the H100 SXM's HBM3 rate, or its integer operations over the int32 peak of
# the SM's 64 INT32 lanes at the 1.98 GHz boost clock, whichever is larger.
HBM_BYTES_PER_S = 3.35e12
INT32_LANES_PER_SM = 64
BOOST_CLOCK_HZ = 1.98e9
# the NW recurrence per DP cell, in the form D = dp + i + j that the kernel
# runs: a compare and a select for the match term, one DPX add-max
# (__viaddmax_s32) for max(diag + s, up) and one max with the left cell
NW_OPS_PER_CELL = 4
# the variant kernel's int32 operations per DP cell, counted from
# csrc/nw.cu::nw_variant_kernel's inner loop of each mode: the match term's
# compare and select in every mode; then local: an add, a DPX add-max and a
# DPX add-max-relu, and the max of the running max; semiglobal: an add and
# two add-max; affine and semiglobal_affine: the diagonal add, an add and
# an add-max for each of the two gap states, one DPX three-way max;
# local_affine: an add and an add-max for each gap state, an add-max, a
# DPX max-relu, and the running max
NW_VARIANT_OPS_PER_CELL = dict(local=6, semiglobal=5, affine=8,
                               local_affine=9, semiglobal_affine=8)
# the padded-batch panels' least int32 work: qc_stats per masked position a
# case fold, a class lookup and its count, the Phred subtract and two
# clamps, the per-position sum, the histogram bin and the row's GC and
# Phred sums; the adapter scan one compare per start column it must test
# (up to the read's first hit); the hashes two multiply-adds per byte
QC_STATS_OPS_PER_POSITION = 10
HASH_OPS_PER_BYTE = 4
# merge_pairs: the bit-sliced compare of csrc/merge.cu takes 32 positions
# of an overlap in 8 int32 operations (three funnel shifts, three
# three-input logic ops, a popc and an add)
MERGE_OPS_PER_COMPARE = 8 / 32
# NWAligner's five variant combinations (mode, gap_open) by the name of
# their kernel mode
NW_VARIANTS = dict(local=("local", None), semiglobal=("semiglobal", None),
                   affine=("global", -3), local_affine=("local", -3),
                   semiglobal_affine=("semiglobal", -3))
# the variant kernel's score sets: the defaults, and others
NW_VARIANT_SCORES = (
    dict(match=1, mismatch=-1, gap=-1, gap_open=-3, gap_extend=-1),
    dict(match=1, mismatch=-1, gap=-2, gap_open=-5, gap_extend=-2))


def log(*a):
    print(*a, flush=True)


# ------------------------------------------------------------- the corpus

def _make_block(seed, block, start, n, binned, planted=False):
    """Records [start, start+n) as a u8[n, RS] matrix, and their oracle
    partials (int64 numpy). `planted`: the tile field takes one of TILES
    and the read starts with one of DEMUX_BARCODES (every 8th of them with a
    substitution, every 16th replaced by noise); then every 8th read carries
    ADAPTER at a random offset and every 16th copies one of its block's
    first 64 reads. The oracle then also holds per-tile Phred sums."""
    rng = np.random.default_rng([seed, block])
    rec = np.empty((n, RS), np.uint8)
    h = len(HEADER)
    rec[:, :h] = np.frombuffer(HEADER, np.uint8)
    idx = np.arange(start, start + n, dtype=np.int64)
    for col, width in _DIGIT_RUNS[::-1]:
        for d in range(width - 1, -1, -1):
            rec[:, col + d] = idx % 10 + 48
            idx //= 10
    draw = rng.integers(0, 256, (n, READ_LEN), dtype=np.uint8)
    phred = rng.integers(2, 42, (n, READ_LEN), dtype=np.uint8)
    if binned:
        phred = _PHRED_LUT[phred].astype(np.uint8)
    if planted:
        tile_k = rng.integers(0, len(TILES), n)
        rec[:, _TILE_COL:_TILE_COL + 4] = np.frombuffer(
            b"".join(b"%d" % t for t in TILES), np.uint8).reshape(-1, 4)[
                tile_k]
        # draws 0..3 are A C G T in _SEQ_LUT
        bc = np.array([[b"ACGT".index(c) for c in b] for b in DEMUX_BARCODES],
                      np.uint8)
        draw[:, :8] = bc[rng.integers(0, len(bc), n)]
        err = np.flatnonzero(rng.random(n) < 1 / 8)
        draw[err, rng.integers(0, 8, len(err))] = rng.integers(
            0, 4, len(err), dtype=np.uint8)
        junk = np.flatnonzero(rng.random(n) < 1 / 16)
        draw[junk, :8] = rng.integers(0, 256, (len(junk), 8), dtype=np.uint8)
        la = len(ADAPTER)
        rows = np.arange(0, n, 8)
        offs = rng.integers(0, READ_LEN - la + 1, len(rows))
        draw[rows[:, None], offs[:, None] + np.arange(la)] = np.array(
            [b"ACGT".index(c) for c in ADAPTER], np.uint8)
        dups = np.arange(5, n, 16)
        draw[dups] = draw[rng.integers(0, min(64, n), len(dups))]
    s0 = h + 1
    q0 = s0 + READ_LEN + 3
    rec[:, h] = 10
    rec[:, s0:s0 + READ_LEN] = _SEQ_LUT[draw]
    rec[:, s0 + READ_LEN:q0] = np.frombuffer(b"\n+\n", np.uint8)
    rec[:, q0:q0 + READ_LEN] = phred + 33
    rec[:, -1] = 10

    cls = _CLASS_LUT[draw]
    pos = np.arange(READ_LEN, dtype=np.int32)
    base_pp = np.bincount((cls * READ_LEN + pos).ravel(),
                          minlength=5 * READ_LEN).reshape(5, READ_LEN)
    gc = ((cls == 1) | (cls == 2)).sum(1)
    qs = phred.sum(1, dtype=np.int64)
    part = dict(
        reads=n,
        base_pp=base_pp,
        qual_pp=phred.sum(0, dtype=np.int64),
        qual_hist=np.bincount(phred.ravel(), minlength=64),
        gc_hist=np.bincount((200 * gc + READ_LEN) // (2 * READ_LEN),
                            minlength=101),
        mq_hist=np.bincount(np.minimum((2 * qs + READ_LEN)
                                       // (2 * READ_LEN), 63), minlength=64),
    )
    if planted:
        part["tile_pp"] = np.stack([phred[tile_k == k].sum(0, dtype=np.int64)
                                    for k in range(len(TILES))])
        part["tile_reads"] = np.bincount(tile_k, minlength=len(TILES))
    return rec, part


def write_corpus(path, n_records, seed, binned=False, planted=False):
    """Write n_records uniform records to `path` (threads generate blocks
    and pwrite them at their offsets) and return the oracle totals."""
    tot = None
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    try:
        def job(b):
            start = b * BLOCK_RECORDS
            n = min(BLOCK_RECORDS, n_records - start)
            rec, part = _make_block(seed, b, start, n, binned, planted)
            view, off = memoryview(rec).cast("B"), start * RS
            while len(view):
                k = os.pwrite(fd, view, off)
                view, off = view[k:], off + k
            return part

        n_blocks = -(-n_records // BLOCK_RECORDS)
        with cf.ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as ex:
            for part in ex.map(job, range(n_blocks)):
                tot = part if tot is None else {
                    k: tot[k] + v for k, v in part.items()}
    finally:
        os.close(fd)
    return tot


def _exclusive_cumsum(a):
    out = np.zeros(len(a), np.int64)
    np.cumsum(a[:-1], out=out[1:])
    return out


def _window_oracle(cls, phred, col, rec, read_len, width):
    """The QC panels of reads (flat base classes, Phreds, columns and
    record indices; read_len per record) over a stats window of `width`
    columns, as int64 numpy arrays (see check_report)."""
    w = col < width
    cls, phred, col, rec = cls[w], phred[w], col[w], rec[w]
    n = len(read_len)
    gc = np.bincount(rec, ((cls == 1) | (cls == 2)).astype(np.int64), n)
    qs = np.bincount(rec, phred.astype(np.int64), n)
    eff = np.minimum(read_len, width)
    count = np.bincount(eff, minlength=width + 1)[::-1].cumsum()[::-1][1:]
    has = eff > 0
    e = eff[has]
    return dict(
        reads=n, bases=int(read_len.sum()),
        base_pp=np.bincount(cls * width + col, minlength=5 * width).reshape(
            5, width),
        count=count,
        qual_pp=np.bincount(col, phred.astype(np.int64), width).astype(
            np.int64),
        qual_hist=np.bincount(phred, minlength=64),
        length_hist=np.bincount(np.minimum(read_len, 511), minlength=512),
        gc_hist=np.bincount((200 * gc.astype(np.int64)[has] + e) // (2 * e),
                            minlength=101),
        mq_hist=np.bincount(np.minimum((2 * qs.astype(np.int64)[has] + e)
                                       // (2 * e), 63), minlength=64))


def _sum_oracles(parts):
    out = dict(parts[0])
    for p in parts[1:]:
        for k, v in p.items():
            out[k] = out[k] + v
    return out


def write_ragged_corpus(path, target_bytes, seed):
    """Write records of RAGGED_LEN read lengths and RAGGED_ID id widths up
    to `target_bytes` (threads fill blocks of records and pwrite them).
    Returns the oracle totals (whole reads; under "window", the panels of
    QCModel's default 256-column window), and every record's start
    offset."""
    rng = np.random.default_rng([seed, 99])
    cap = target_bytes // RAGGED_MIN_RECORD + 1
    read_len = rng.integers(RAGGED_LEN[0], RAGGED_LEN[1] + 1, cap)
    id_len = rng.integers(RAGGED_ID[0], RAGGED_ID[1] + 1, cap)
    size = id_len + 2 * read_len + 6
    n = int(np.searchsorted(np.cumsum(size), target_bytes, side="right"))
    read_len, id_len, size = read_len[:n], id_len[:n], size[:n]
    starts = _exclusive_cumsum(size)
    block = 1 << 17
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)

    def job(b):
        lo, hi = b * block, min(n, (b + 1) * block)
        rl, il = read_len[lo:hi], id_len[lo:hi]
        st = starts[lo:hi] - starts[lo]
        brng = np.random.default_rng([seed, 99, b])
        buf = np.empty(int(size[lo:hi].sum()), np.uint8)
        rec = np.repeat(np.arange(hi - lo), il)
        col = np.arange(len(rec)) - np.repeat(_exclusive_cumsum(il), il)
        buf[st[rec] + 1 + col] = _ID_LUT[brng.integers(0, len(_ID_LUT),
                                                       len(rec))]
        draw = brng.integers(0, 256, int(rl.sum()), dtype=np.uint8)
        phred = brng.integers(2, 42, len(draw), dtype=np.uint8)
        rec = np.repeat(np.arange(hi - lo), rl)
        col = np.arange(len(rec)) - np.repeat(_exclusive_cumsum(rl), rl)
        seq_pos = st[rec] + il[rec] + 2 + col
        buf[seq_pos] = _SEQ_LUT[draw]
        buf[seq_pos + rl[rec] + 3] = phred + 33
        del seq_pos
        sep = st + il + 2 + rl
        buf[st] = ord("@")
        buf[st + il + 1] = 10
        buf[sep] = 10
        buf[sep + 1] = ord("+")
        buf[sep + 2] = 10
        buf[sep + 3 + rl] = 10
        view, off = memoryview(buf).cast("B"), int(starts[lo])
        while len(view):
            k = os.pwrite(fd, view, off)
            view, off = view[k:], off + k
        cls = _CLASS_LUT[draw]
        return (np.bincount(cls, minlength=5),
                np.bincount(phred, minlength=64),
                _window_oracle(cls, phred, col, rec, rl, QC_WIDTH))

    try:
        with cf.ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as ex:
            parts = list(ex.map(job, range(-(-n // block))))
    finally:
        os.close(fd)
    oracle = dict(reads=n, bases=int(read_len.sum()),
                  bytes=int(size.sum()),
                  base_counts=sum(p[0] for p in parts),
                  qual_hist=sum(p[1] for p in parts),
                  window=_sum_oracles([p[2] for p in parts]))
    return oracle, np.append(starts, oracle["bytes"])


def _deflate_span(mm, lo, hi, level):
    """The raw deflate of mm[lo:hi], primed with the 32 KiB before it and
    ended by a sync flush, or by the final block at the end of mm."""
    kw = dict(zdict=mm[max(0, lo - (1 << 15)):lo]) if lo else {}
    c = zlib.compressobj(level, zlib.DEFLATED, -15, **kw)
    return c.compress(mm[lo:hi]) + c.flush(
        zlib.Z_FINISH if hi == len(mm) else zlib.Z_SYNC_FLUSH)


def _bgzf_block(mm, lo, hi, level):
    """One BGZF block of mm[lo:hi]: a gzip member with the BC extra field
    holding its size, as io/writers.BGZFWriter writes it."""
    payload = mm[lo:hi]
    c = zlib.compressobj(level, zlib.DEFLATED, -15)
    body = c.compress(payload) + c.flush()
    if len(body) + 26 > 1 << 16:
        raise ValueError("a BGZF block of %d bytes does not compress "
                         "below 64 KiB" % len(payload))
    return (b"\x1f\x8b\x08\x04" + b"\x00" * 6
            + struct.pack("<HBBHH", 6, 66, 67, 2, len(body) + 25)
            + body + struct.pack("<II", zlib.crc32(payload),
                                 len(payload) & 0xFFFFFFFF))


def write_compressed(src, dst, fmt):
    """Compress the FASTQ file `src` into `dst`, the spans deflated by a
    thread pool (zlib releases the GIL). "gzip": one gzip member at zlib
    level 1, laid out as pigz writes it (1 MiB spans, each primed with the
    32 KiB before it and ended by a sync flush), so any inflater reads one
    deflate stream with references across the spans. "bgzf": the bgzip
    format at zlib level 6 (64 KiB blocks, then the EOF block). Returns the
    compressed size."""
    span, job, level = ((GZIP_BLOCK, _deflate_span, 1) if fmt == "gzip"
                        else (BGZF_PAYLOAD, _bgzf_block, 6))
    crc = 0
    with open(src, "rb") as f, open(dst, "wb") as out:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        try:
            n = len(mm)
            if fmt == "gzip":
                out.write(b"\x1f\x8b\x08\x00\x00\x00\x00\x00\x00\xff")
            with cf.ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as ex:
                for lo0 in range(0, n, 64 * span):
                    spans = [(lo, min(lo + span, n)) for lo in
                             range(lo0, min(lo0 + 64 * span, n), span)]
                    parts = [ex.submit(job, mm, lo, hi, level)
                             for lo, hi in spans]
                    if fmt == "gzip":
                        for lo, hi in spans:
                            crc = zlib.crc32(mm[lo:hi], crc)
                    for part in parts:
                        out.write(part.result())
        finally:
            mm.close()
        out.write(struct.pack("<II", crc, n & 0xFFFFFFFF) if fmt == "gzip"
                  else BGZF_EOF)
    return os.path.getsize(dst)


def _semi_block(seed, block, start, n):
    """Records [start, start+n) of the semi-uniform corpus, as bytes: the
    uniform block's reads (and its oracle partials) under Illumina-style
    ids whose tile, x and y fields are not zero-padded, so that the id
    widths vary by several bytes."""
    rec, part = _make_block(seed, block, start, n, False)
    rng = np.random.default_rng([seed, block, 5])
    fields = (rng.integers(1101, 2229, n), rng.integers(1, 32001, n),
              rng.integers(1, 40001, n))
    body = rec[:, len(HEADER):]  # '\n' seq '\n+\n' qual '\n'
    width = len(SEMI_PREFIX) + 4 + 2 * 6 + len(SEMI_SUFFIX)
    mat = np.zeros((n, width + body.shape[1]), np.uint8)
    mat[:, :len(SEMI_PREFIX)] = np.frombuffer(SEMI_PREFIX, np.uint8)
    at = np.full(n, len(SEMI_PREFIX))
    rows = np.arange(n)
    for k, v in enumerate(fields):
        if k:
            mat[rows, at] = ord(":")
            at = at + 1
        digits = 1 + sum((v >= 10 ** d).astype(np.int64) for d in range(1, 5))
        for d in range(5):
            m = d < digits
            mat[rows[m], at[m] + digits[m] - 1 - d] = (
                v[m] // 10 ** d % 10 + 48)
        at = at + digits
    for k, c in enumerate(SEMI_SUFFIX):
        mat[rows, at + k] = c
    at = at + len(SEMI_SUFFIX)
    for h in np.unique(at):
        m = at == h
        mat[m, h:h + body.shape[1]] = body[m]
    keep = np.arange(mat.shape[1])[None, :] < (at + body.shape[1])[:, None]
    return mat[keep].tobytes(), part


def write_semi_corpus(path, n_records, seed):
    """Write n_records semi-uniform records (READ_LEN bp reads, ids of
    varying width) to `path` and return the oracle totals."""
    n_blocks = -(-n_records // BLOCK_RECORDS)

    def job(b):
        start = b * BLOCK_RECORDS
        return _semi_block(seed, b, start,
                           min(BLOCK_RECORDS, n_records - start))

    tot = None
    with open(path, "wb") as f, \
            cf.ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as ex:
        for blob, part in ex.map(job, range(n_blocks)):
            f.write(blob)
            tot = part if tot is None else {k: tot[k] + v
                                            for k, v in part.items()}
    return tot


# ----------------------------------------- edge cases of the ragged kernel

def _ragged_records(rng, read_lens, id_lens, qual_lo=33, qual_hi=74):
    """One FASTQ record (bytes) per (read length, id width): bases from
    _SEQ_LUT (upper and lower case, N), ids from _ID_LUT, Phreds drawn in
    [qual_lo, qual_hi]."""
    out = []
    for rl, il in zip(read_lens, id_lens):
        out.append(b"@" + _ID_LUT[rng.integers(0, len(_ID_LUT), il)].tobytes()
                   + b"\n" + _SEQ_LUT[rng.integers(0, 256, rl)].tobytes()
                   + b"\n+\n" + rng.integers(qual_lo, qual_hi + 1, rl)
                   .astype(np.uint8).tobytes() + b"\n")
    return out


def _fault(kind, rec):
    """`rec` with the fault `kind` of _FAULTS."""
    il = rec.index(b"\n") - 1
    return _FAULTS[kind](rec, il, rec.index(b"\n", il + 2) - il - 2)


def _edge_records(rng, width, n=600):
    """Records of every edge length for `width` (0, 1, 15-17, width - 1 to
    width + 1, 3 x width) and random lengths up to 3 x width, with ids of
    1 to 200 bytes."""
    edges = [0, 1, 15, 16, 17, width - 1, width, width + 1, 3 * width]
    lens = np.concatenate([np.tile(edges, 10), rng.integers(
        0, 3 * width + 1, n - 10 * len(edges))])
    ids = rng.integers(1, 201, n)
    ids[:4] = (1, 200, 1, 200)
    return _ragged_records(rng, lens, ids)


# each kind of invalid record: (record bytes, id width, read length) ->
# the record with one fault (reads of 8 bases or more)
_FAULTS = {
    "no '@'": lambda r, il, rl: b"X" + r[1:],
    "no '+'": lambda r, il, rl: r[:il + 3 + rl] + b"-" + r[il + 4 + rl:],
    "high bit in the id": lambda r, il, rl: r[:1] + bytes([r[1] | 0x80])
    + r[2:],
    "high bit in the seq": lambda r, il, rl: r[:il + 9] + bytes(
        [r[il + 9] | 0x80]) + r[il + 10:],
    "high bit in the qual": lambda r, il, rl: r[:il + 9 + rl] + b"\xc1"
    + r[il + 10 + rl:],
    "high bit on the '+' line": lambda r, il, rl: r[:il + 4 + rl] + b"\xc1"
    + r[il + 4 + rl:],
    "quality below the range": lambda r, il, rl: r[:il + 9 + rl] + b" "
    + r[il + 10 + rl:],
    "quality above the range": lambda r, il, rl: r[:il + 9 + rl] + b"\x7f"
    + r[il + 10 + rl:],
    "qual shorter than seq": lambda r, il, rl: r[:-2] + b"\n",
    "newline inside the seq": lambda r, il, rl: r[:il + 9] + b"\n"
    + r[il + 10:],
}


def _record_ending_at(rng, s, k, target):
    """A record starting at offset s whose newline k (0: id, 1: seq,
    2: '+', 3: qual line) lies at offset `target` (target - s >= 40)."""
    span = target - s
    if k == 0:
        il, rl = span - 1, int(rng.integers(0, 50))
    elif k == 1:
        il = int(rng.integers(1, 10))
        rl = span - 2 - il
    elif k == 2:
        il = int(rng.integers(1, 10))
        rl = span - 4 - il
    else:
        il = 1 + (span - 6) % 2
        rl = (span - 5 - il) // 2
    return _ragged_records(rng, [rl], [il])[0]


def _tile_records(rng, tile, plan, lens=(0, 300), ids=(1, 60)):
    """Records over len(plan) + 1 tiles of `tile` bytes: plan[j] = (k, d)
    puts newline k of the record across boundary j + 1 at d bytes past
    the boundary's first byte (d = -1: on the last byte before it)."""
    out, s = [], 0
    for j, (k, d) in enumerate(plan):
        target = (j + 1) * tile + d
        while True:
            rec = _ragged_records(rng, [int(rng.integers(*lens))],
                                  [int(rng.integers(*ids))])[0]
            if s + len(rec) + 48 > target:
                break
            out.append(rec)
            s += len(rec)
        rec = _record_ending_at(rng, s, k, target)
        out.append(rec)
        s += len(rec)
    while s < (len(plan) + 1) * tile:
        rec = _ragged_records(rng, [int(rng.integers(*lens))],
                              [int(rng.integers(*ids))])[0]
        out.append(rec)
        s += len(rec)
    return out


# bs_ragged_qc keeps its per-position rows in shared memory up to a width
# of about 7,600 and adds them straight into global memory above it: 8192
# takes that branch. The tile cases aim at the kernel's tiles of
# ops/ragged_qc.py's TILE_BYTES (the views start 16-byte aligned there):
# boundaries inside each of the four lines of a record, boundaries just
# past a newline of each phase (phase 3: a record starts on the tile's
# first byte), a record past three tiles and the window's halo, a tile
# with no newline, a chunk shorter than a tile, and tiles so dense in
# records that their newlines take several rounds of the kernel's list.
RAGGED_TILE_CASES = (
    ["tile boundary inside line %d" % k for k in range(4)]
    + ["tile boundaries just past a newline of each phase",
       "a record longer than three tiles", "a tile with no newline",
       "chunk shorter than one tile", "dense tiles of 0-2 base reads"])
RAGGED_EDGE_CASES = tuple(
    ["w=%d %s" % (w, k) for w in (128, 256, 384, 1024, 8192)
     for k in ("clean", "partial tail", "checks off")]
    + ["invalid: " + k for k in _FAULTS]
    + ["empty chunk", "no complete record", "tiny chunk",
       "padding past n_valid", "view 5 bytes off alignment",
       "view 1 byte off, odd length", "length off a multiple of 128",
       "illumina_1.3 schema", "eq-mode, every value seen",
       "eq-mode, a value missed"]
    + RAGGED_TILE_CASES)


def _tile_case(label, rng):
    """The records of one of RAGGED_TILE_CASES, and the bytes to put
    before them on the card."""
    from blazeseq_tpu_torch.ops.ragged_qc import TILE_BYTES as tile

    if label.startswith("tile boundary inside line"):
        # newline k lands 0-7 bytes past the boundary: the boundary falls
        # inside line k (on the '+' line, between '+' and its newline)
        k = int(label[-1])
        return _tile_records(rng, tile, [(k, 0 if k == 2 else int(
            rng.integers(0, 8))) for _ in range(2)]), 0
    if label.startswith("tile boundaries just past"):
        return _tile_records(rng, tile, [(k, -1) for k in range(4)]), 0
    if label == "a record longer than three tiles":
        recs = _tile_records(rng, tile, [])
        return (recs[:10] + _ragged_records(rng, [100_000], [30])
                + recs[10:]), 0
    if label == "a tile with no newline":
        recs = _tile_records(rng, tile, [])
        return recs[:5] + _ragged_records(rng, [40], [2 * tile]) + recs, 0
    if label == "chunk shorter than one tile":
        # at most 4 x 446 bytes, under one tile with the view's offset
        recs = _ragged_records(rng, rng.integers(0, 201, 4),
                               rng.integers(1, 41, 4))
        return recs, 3
    # 0-2 base reads with 1-byte ids: 7-11 bytes a record
    return _ragged_records(rng, rng.integers(0, 3, 3 * tile // 9),
                           np.ones(3 * tile // 9, np.int64)), 0


def ragged_edge_case(label, seed):
    """One edge case of the ragged kernel: (chunk bytes u8[n], the bytes to
    put before it on the card (a view that far into its storage), n_valid,
    ragged_qc's keyword arguments)."""
    rng = np.random.default_rng([seed, 9, RAGGED_EDGE_CASES.index(label)])
    kw = dict(width=QC_WIDTH, q_lo=33, q_hi=126, offset=33, check_ascii=True,
              check_quality=True, hist_vals=(), len_vals=())
    off = 0
    if label.startswith("w="):
        width = int(label[2:].split()[0])
        kw["width"] = width
        # fewer records at the widest window: reads of 3 x 8192 bases
        recs = _edge_records(rng, width, 600 if width <= 1024 else 120)
        if label.endswith("checks off"):
            # reads of width - 1, width and width + 1 bases
            recs[5] = _fault("high bit in the seq", recs[5])
            recs[6] = _fault("quality above the range", recs[6])
            recs[7] = _fault("high bit in the qual", recs[7])
            kw.update(check_ascii=False, check_quality=False)
        buf = b"".join(recs)
        n_valid = len(buf) - (37 if label.endswith("partial tail") else 0)
    elif label.startswith("invalid: "):
        recs = _edge_records(rng, 256, 200)
        recs[100] = _fault(label[9:], _ragged_records(rng, [255], [20])[0])
        buf = b"".join(recs)
        n_valid = len(buf)
    elif label == "empty chunk":
        buf, n_valid = bytes(256), 0
    elif label == "no complete record":
        buf = b"@r1 x\nACGTN\n+\nIIII"
        n_valid = len(buf)
    elif label == "tiny chunk":
        buf = b"@a\nAC\n+\nII\n@b\n\n+\n\n@c\nG"
        n_valid = len(buf)
    elif label == "padding past n_valid":
        recs = _edge_records(rng, 128, 100)
        buf = b"".join(recs)
        n_valid = len(buf)
        buf += b"X\n\xff\n@\n\n" * 40
    elif label.startswith("view") or label.startswith("length off"):
        buf = b"".join(_edge_records(rng, 256, 300))
        off = {"view 5": 5, "view 1": 1}.get(label[:6], 0)
        if label.startswith("view 5"):
            buf = buf[:len(buf) // 128 * 128]
        n_valid = len(buf)
    elif label in RAGGED_TILE_CASES:
        recs, off = _tile_case(label, rng)
        buf = b"".join(recs)
        n_valid = len(buf)
        if label == "chunk shorter than one tile":
            n_valid -= 11  # a partial last record
    elif label == "illumina_1.3 schema":
        buf = b"".join(_ragged_records(rng, rng.integers(0, 400, 300),
                                       rng.integers(1, 60, 300), 64, 104))
        kw.update(q_lo=64, q_hi=104, offset=64)
        n_valid = len(buf)
    else:  # the eq-mode cases: binned Phreds, lengths 40-80 but 60
        lens = rng.integers(40, 81, 500)
        recs = _ragged_records(rng, lens, rng.integers(1, 60, 500))
        buf = bytearray(b"".join(recs))
        nl = np.flatnonzero(np.frombuffer(bytes(buf), np.uint8) == 10)
        for s, e in zip(nl[2::4], nl[3::4]):
            q = np.frombuffer(bytes(buf[s + 1:e]), np.uint8).astype(int) - 33
            buf[s + 1:e] = (_PHRED_LUT[q] + 33).astype(np.uint8).tobytes()
        if label.endswith("missed"):
            buf[int(nl[2]) + 1] = 33 + 9
            kw["len_vals"] = tuple(v for v in range(40, 81) if v != 60)
        else:
            kw["len_vals"] = tuple(range(40, 81))
        kw["hist_vals"] = tuple(int(v) for v in NOVASEQ_BINS)
        buf = bytes(buf)
        n_valid = len(buf)
    return np.frombuffer(buf, np.uint8).copy(), off, n_valid, kw


# the device-parse API's edge cases (raw_stream_qc, newline_positions_device,
# record_offsets_device, gather_padded_device, parse_fastq_device,
# count_records_device), shared by phase_kernel_device_parse and the CPU
# tests against the reference: line ends, case, flags in complete records
# and in the partial tail, structure codes, the gather reading on past a
# short quality line, the arguments' limits, views off 16-byte alignment,
# several 16 KiB tiles of csrc/parse.cu, every chunk length mod 128, and
# the places of csrc/parse.cu's 64-bit masks: the last complete record's
# newline at bits 0, 31, 32 and 63 of a thread's 64 bytes, line starts at a
# thread's first byte, a quality value counted past the 8-bit counters'
# reach, and Phred bin 255
DEVICE_PARSE_EDGE_CASES = (
    "empty chunk", "fewer than 4 newlines", "no final newline", "CRLF file",
    "lower-case bases and N", "high bit in a header",
    "high bit in the partial tail", "quality out of range in the partial tail",
    "missing '@'", "missing '+'", "quality line shorter than its sequence",
    "short quality line at the chunk's end", "quality bounds 289/382",
    "max_phred 42", "count above max_records",
    "start in the middle of a record", "start at n",
    "max_len below the read length", "caller-made offsets with -1 rows",
    "view 1 byte in", "view 3 bytes in", "view 13 bytes in",
    "3 tiles of records, view 5 bytes in", "2 tiles of newlines only",
    "last record's newline at bit 0", "last record's newline at bit 31",
    "last record's newline at bit 32", "last record's newline at bit 63",
    "'@' and '+' at a thread's first byte",
    "missing '@' at a thread's first byte",
    "missing '+' at a thread's first byte",
    "one quality value over 5 tiles", "max_phred 256 with bytes at 255",
) + tuple("n %% 128 = %d" % r for r in range(128))


def _widen_id(recs, j, pad):
    """recs with record j's id `pad` bytes longer."""
    recs = list(recs)
    recs[j] = recs[j][:1] + b"x" * pad + recs[j][1:]
    return recs


def _line_at_bit(recs, j, line, bit):
    """recs with line `line` (0 the header, 2 the separator) of record j
    (j >= 1) starting at a chunk index equal to `bit` mod 64, by widening
    the id before it."""
    start = len(b"".join(recs[:j]))
    if line == 2:
        start += recs[j].index(b"\n+\n") + 1
    k = j if line == 2 else j - 1
    return _widen_id(recs, k, (bit - start) % 64)


def device_parse_edge_case(label, seed):
    """One case of DEVICE_PARSE_EDGE_CASES: a dict with the chunk (data,
    u8[n]), the bytes to put before it in its storage (off), the quality
    arguments of raw_stream_qc (q_lower, q_upper, offset, max_phred),
    max_count, max_records, start (record_offsets_device), max_len, and
    caller-made offsets for gather_padded_device (None: record_offsets_
    device's)."""
    rng = np.random.default_rng([seed, 15, DEVICE_PARSE_EDGE_CASES.index(
        label)])

    def records(k, lens=(0, 41), ids=(1, 12), **kw):
        return _ragged_records(rng, rng.integers(*lens, k),
                               rng.integers(*ids, k), **kw)

    recs = records(24)
    case = dict(off=0, q_lower=33, q_upper=126, offset=33, max_phred=64,
                start=0, max_len=48, offsets=None)
    if label == "empty chunk":
        buf = b""
    elif label == "fewer than 4 newlines":
        buf = b"@r1\nACGT\n+\n"
    elif label == "no final newline":
        buf = b"".join(recs)[:-1]
    elif label == "CRLF file":
        buf = b"".join(recs).replace(b"\n", b"\r\n")
    elif label == "lower-case bases and N":
        recs = [r[:r.index(b"\n") + 1] + rng.choice(np.frombuffer(
            b"ACGTNacgtn", np.uint8), 30).tobytes() + b"\n+\n"
            + b"I" * 30 + b"\n" for r in recs]
        buf = b"".join(recs)
    elif label == "high bit in a header":
        recs[2] = recs[2][:1] + b"\xc1" + recs[2][2:]
        buf = b"".join(recs)
    elif label.endswith("in the partial tail"):
        bad = b"@tail\nAC\xc1T\n+\nII" if label.startswith("high") \
            else b"@tail\nACGT\n+\nI\x10\x7fI"
        buf = b"".join(recs) + bad
    elif label == "missing '@'":
        recs[3] = b"X" + recs[3][1:]
        buf = b"".join(recs)
    elif label == "missing '+'":
        recs[3] = _FAULTS["no '+'"](recs[3], recs[3].index(b"\n") - 1,
                                    recs[3].index(b"\n+") - recs[3].index(
                                        b"\n") - 1)
        buf = b"".join(recs)
    elif label == "quality line shorter than its sequence":
        recs[5] = records(1, (20, 41))[0][:-3] + b"\n"
        buf = b"".join(recs)
    elif label == "short quality line at the chunk's end":
        recs[-1] = records(1, (20, 41))[0][:-4] + b"\n"
        buf = b"".join(recs)
    elif label == "quality bounds 289/382":
        recs[4] = records(1, (5, 41))[0][:-2] + b" \n"
        buf = b"".join(recs)
        case.update(q_lower=289, q_upper=382)
    elif label == "max_phred 42":
        buf = b"".join(records(24, qual_lo=33, qual_hi=110))
        case.update(max_phred=42)
    elif label == "count above max_records":
        buf = b"".join(recs)
        case.update(max_records=5)
    elif label == "start in the middle of a record":
        buf = b"".join(recs)
        case.update(start=len(b"".join(recs[:3])) + 5)
    elif label == "start at n":
        buf = b"".join(recs)
        case.update(start=len(buf))
    elif label == "max_len below the read length":
        buf = b"".join(records(24, (20, 41)))
        case.update(max_len=20)
    elif label == "caller-made offsets with -1 rows":
        buf = b"".join(recs)
        offs = rng.integers(-3, len(buf) + 4, (40, 5)).astype(np.int32)
        offs[::3, 0] = -1
        offs[1::4, 2] = offs[1::4, 1] - 5  # negative lengths
        case.update(offsets=offs)
    elif label.startswith("view"):
        buf = b"".join(recs) + b"@x\nAC"
        case.update(off=int(label.split()[1]))
    elif label.startswith("3 tiles"):
        buf = b"".join(records(800, (0, 60), (1, 40)))[:3 * 16384 - 100]
        case.update(off=5, max_len=64)
    elif label.startswith("2 tiles"):
        buf = b"\n" * (2 * 16384 + 7)
    elif label.startswith("last record's newline at bit"):
        # its final newline at that bit of a thread's 64 bytes, then a tail
        bit = int(label.split()[-1])
        end = len(b"".join(recs)) - 1
        buf = b"".join(_widen_id(recs, len(recs) - 1, (bit - end) % 64)) \
            + b"@t\nAC"
    elif label.endswith("at a thread's first byte"):
        # a line that starts at bit 0 of a thread's 64 bytes, after a
        # newline at the last byte of the thread before
        recs = _line_at_bit(_line_at_bit(recs, 5, 0, 0), 9, 2, 0)
        if label.startswith("missing '@'"):
            recs[5] = b"X" + recs[5][1:]
        elif label.startswith("missing '+'"):
            i = recs[9].index(b"\n+\n") + 1
            recs[9] = recs[9][:i] + b"-" + recs[9][i + 1:]
        buf = b"".join(recs)
    elif label == "one quality value over 5 tiles":
        big = 5 * 16384 + 100
        buf = b"".join(recs[:3]) + b"@big\n" + _SEQ_LUT[rng.integers(
            0, 256, big)].tobytes() + b"\n+\n" + b"I" * big + b"\n" \
            + b"".join(recs[3:6]) + b"@t\nA"
    elif label == "max_phred 256 with bytes at 255":
        recs = records(24, qual_lo=11, qual_hi=255)
        recs[7] = recs[7][:recs[7].index(b"\n+\n") + 3] + b"\xff" * (
            len(recs[7]) - recs[7].index(b"\n+\n") - 4) + b"\n"
        buf = b"".join(recs)
        case.update(q_lower=0, q_upper=255, offset=0, max_phred=256)
    else:  # "n % 128 = r": a chunk of 384 + r bytes, views at 0, 1, 3, 13
        r = int(label.split()[-1])
        buf = b"".join(records(40))[:384 + r]
        case.update(off=(0, 1, 3, 13)[r % 4])
    data = np.frombuffer(buf, np.uint8).copy()
    max_records = case.get("max_records",
                           int(np.count_nonzero(data == 10)) // 4 + 3)
    if case["offsets"] is not None:
        max_records = len(case["offsets"])
    case.update(data=data, max_records=max_records,
                max_count=4 * max_records + 2)
    return case


# the device-parse API's card-only cases: 1,024 tiles of csrc/parse.cu and
# more, so that the compaction's look-back runs under contention, views 0,
# 1 and 13 bytes past 16-byte alignment, each run MANY_TILE_RUNS times;
# and a quality line of one value over 8,192 tiles, which a lane of the
# QC pass's persistent grid meets in more tiles than its 8-bit counters
# hold without a flush
MANY_TILE_CASES = ("16 MiB of records", "16 MiB of newlines",
                   "128 MiB of one quality value")
MANY_TILE_OFFSETS = (0, 1, 13)
MANY_TILE_RUNS = 20


def device_parse_many_tiles(label, seed):
    """One case of MANY_TILE_CASES: the chunk (u8[n], numpy)."""
    rng = np.random.default_rng([seed, 16, MANY_TILE_CASES.index(label)])
    n = 16 << 20
    if label == "16 MiB of records":
        k = n // 300
        buf = b"".join(_ragged_records(
            rng, rng.integers(RAGGED_LEN[0], RAGGED_LEN[1] + 1, k),
            rng.integers(RAGGED_ID[0], RAGGED_ID[1] + 1, k)))[:n]
        return np.frombuffer(buf, np.uint8).copy()
    if label == "16 MiB of newlines":
        return np.full(n + 5, 10, np.uint8)
    head = np.frombuffer(b"@q\nACGT\n+\n", np.uint8)
    tail = np.frombuffer(b"\n" + b"".join(_ragged_records(
        rng, (40, 41), (12, 12))) + b"@t\nA", np.uint8)
    return np.concatenate([head, np.full(128 << 20, ord("I"), np.uint8),
                           tail])


def write_mates(path1, path2, n, seed):
    """n read pairs from FRAG_LEN bp fragments: R1 = the first READ_LEN
    bases, R2 = the reverse complement of the last READ_LEN, each with its
    own random qualities; ids P<index>/1 and /2."""
    rng = np.random.default_rng([seed, 77])
    frag = rng.integers(0, 4, (n, FRAG_LEN), dtype=np.uint8)
    h = len(MATE_HEADER)
    rs = h + 1 + READ_LEN + 3 + READ_LEN + 1
    for path, mate, bases in (
            (path1, b"1", _SEQ_LUT[frag[:, :READ_LEN]]),
            (path2, b"2", _COMP_LUT[frag[:, :FRAG_LEN - READ_LEN - 1:-1]])):
        rec = np.empty((n, rs), np.uint8)
        rec[:, :h] = np.frombuffer(MATE_HEADER[:-1] + mate, np.uint8)
        idx = np.arange(n, dtype=np.int64)
        for d in range(8, 1, -1):
            rec[:, d] = idx % 10 + 48
            idx //= 10
        rec[:, h] = 10
        rec[:, h + 1:h + 1 + READ_LEN] = bases
        rec[:, h + 1 + READ_LEN:h + 4 + READ_LEN] = np.frombuffer(b"\n+\n",
                                                                  np.uint8)
        rec[:, h + 4 + READ_LEN:-1] = rng.integers(35, 75, (n, READ_LEN),
                                                   dtype=np.uint8)
        rec[:, -1] = 10
        rec.tofile(path)
    return rs


# merge_pairs' edge cases (csrc/merge.cu), shared by phase_kernel_merge and
# the CPU tests against the reference. Each is (seq1, qual1, len1, seq2,
# qual2, len2) and merge_pairs' keywords; the bytes of a row past its read
# are random, which no output may read.
MERGE_EDGE_CASES = (
    "planted overlaps", "lengths above L (to_padded max_len)",
    "zero-length reads", "min_overlap 0", "min_overlap -1",
    "min_overlap above L", "mismatch_penalty 0", "mismatch_penalty 3",
    "max_mismatch_frac 0.0", "max_mismatch_frac 0.1",
    "max_mismatch_frac 1.0", "lowercase, N and other bytes",
    "a tie at two overlaps", "L = 1", "L = 17", "L = 300", "n = 0",
    "int64 lengths", "every byte value in R1", "ties far apart at L = 256")
# the card-only ones: the merge command's batch, wide rows whose staging
# takes fewer warps a block (csrc/merge.cu: 8 and 4 on the H100's 227 KB
# a block), MiSeq amplicon mates (2 x 300 bp of 450-550 bp fragments,
# padded to 384), and rows too wide for one warp's slice of shared memory
# (about 7 bytes a column), which the kernel reads from device memory
MERGE_CARD_CASES = ("the merge command's batch, 4,096 x 256",
                    "wide rows, L = 4,080", "wide rows, L = 4,200",
                    "MiSeq 2 x 300, 4,096 x 384",
                    "rows wider than the staging, L = 34,000")
MERGE_BATCH = 4096  # pairs a batch of the merge command
_MERGE_COMP = np.full(256, ord("N"), np.uint8)
_MERGE_COMP[np.frombuffer(b"ACGTacgtN", np.uint8)] = np.frombuffer(
    b"TGCATGCAN", np.uint8)


def _mate_reads(rng, len1, len2, overlap, errors=0, alphabet=b"ACGT"):
    """Read pairs from fragments: R1 = the first len1 bases, R2 the reverse
    complement of the last len2, the two sharing `overlap` bases (clipped
    to the shorter read); `errors` bases of R1 inside the overlap changed.
    Lists of u8 arrays."""
    a = np.frombuffer(alphabet, np.uint8)
    n = len(len1)
    overlap, errors = (np.broadcast_to(x, n) for x in (overlap, errors))
    r1, r2 = [], []
    for i in range(n):
        l1, l2 = max(int(len1[i]), 0), max(int(len2[i]), 0)
        o = min(int(overlap[i]), l1, l2)
        frag = rng.choice(a, l1 + l2 - o)
        s1 = frag[:l1].copy()
        k = min(int(errors[i]), o)
        if k:
            at = l1 - o + rng.choice(o, k, replace=False)
            s1[at] = np.where(s1[at] == ord("A"), ord("C"), ord("A"))
        r1.append(s1)
        r2.append(_MERGE_COMP[frag[len(frag) - l2:][::-1]])
    return r1, r2


def _mate_rows(rng, reads, L, lengths=None):
    """u8[n, L] rows of the reads (the first L bases, random bytes after
    them), random qualities in [33, 75) over the whole row, and the
    lengths (true ones, even past L; `lengths` replaces them)."""
    n = len(reads)
    seq = rng.integers(0, 256, (n, L)).astype(np.uint8)
    for i, r in enumerate(reads):
        k = min(len(r), L)
        seq[i, :k] = r[:k]
    qual = rng.integers(33, 75, (n, L)).astype(np.uint8)
    if lengths is None:
        lengths = [len(r) for r in reads]
    return seq, qual, np.asarray(lengths, np.int32)


def _mates(rng, L, len1, len2, overlap, errors=0, alphabet=b"ACGT"):
    r1, r2 = _mate_reads(rng, len1, len2, overlap, errors, alphabet)
    s1, q1, n1 = _mate_rows(rng, r1, L, len1)
    s2, q2, n2 = _mate_rows(rng, r2, L, len2)
    return s1, q1, n1, s2, q2, n2


def _to_padded_mates(rng, len1, len2, overlap, max_len):
    """Pairs padded by the port's FastqBatch.to_padded(max_len=): rows
    clamped to L = max_len rounded up to 128, lengths true."""
    from blazeseq_tpu_torch.fastq.batch import FastqBatch

    out = []
    errors = rng.integers(0, 3, len(len1))
    for reads in _mate_reads(rng, len1, len2, overlap, errors):
        ends = np.cumsum([len(r) for r in reads]).astype(np.int64)
        seq = np.concatenate(reads)
        qual = rng.integers(33, 75, len(seq)).astype(np.uint8)
        pb = FastqBatch.from_arrays(seq, qual, ends, np.zeros(0, np.uint8),
                                    np.zeros(len(ends), np.int64)).to_padded(
            max_len=max_len)
        out += [pb.seq, pb.qual, pb.lengths]
    return tuple(out)


def merge_edge_case(label, seed):
    """One case of MERGE_EDGE_CASES or MERGE_CARD_CASES: ((seq1, qual1,
    len1, seq2, qual2, len2) as numpy arrays, merge_pairs' keywords)."""
    cases = MERGE_EDGE_CASES + MERGE_CARD_CASES
    rng = np.random.default_rng([seed, 29, cases.index(label)])

    def planted(n, L, lens=None, overlap=None, errors=None, **kw):
        lens = (1, L + 1) if lens is None else lens
        len1, len2 = rng.integers(*lens, n), rng.integers(*lens, n)
        ov = rng.integers(0, L + 1, n) if overlap is None else overlap
        er = rng.integers(0, 4, n) if errors is None else errors
        return _mates(rng, L, len1, len2, ov, er, **kw)

    kw = {}
    if label == "planted overlaps":
        arrays = planted(96, 64)
    elif label == "lengths above L (to_padded max_len)":
        n = 64
        arrays = _to_padded_mates(rng, rng.integers(100, 400, n),
                                  rng.integers(100, 400, n),
                                  rng.integers(20, 300, n), 150)
    elif label == "zero-length reads":
        len1, len2 = rng.integers(0, 33, 48), rng.integers(0, 33, 48)
        len1[::3] = 0
        len2[1::4] = 0
        arrays = _mates(rng, 32, len1, len2, rng.integers(0, 33, 48))
    elif label.startswith("min_overlap"):
        L = 48
        kw["min_overlap"] = {"0": 0, "-1": -1}.get(label.split()[1], L + 3)
        # short overlaps, where a bound at or below 1 matters
        arrays = planted(64, L, overlap=rng.integers(0, 9, 64),
                         errors=np.zeros(64, np.int64))
    elif label.startswith("mismatch_penalty"):
        kw["mismatch_penalty"] = int(label.split()[1])
        arrays = planted(96, 64, errors=rng.integers(0, 8, 96))
    elif label.startswith("max_mismatch_frac"):
        frac = float(label.split()[1])
        kw.update(max_mismatch_frac=frac, min_overlap=5)
        if frac == 0.1:
            # overlaps of 10 k bases with k mismatches (accepted at the
            # fp32 edge) or k + 1
            ov = 10 * rng.integers(1, 7, 96)
            er = ov // 10 + rng.integers(0, 2, 96)
            arrays = planted(96, 80, lens=(70, 81), overlap=ov, errors=er)
        else:
            arrays = planted(96, 64, errors=rng.integers(0, 6, 96))
    elif label == "lowercase, N and other bytes":
        # mostly upper case, so that some pairs still merge
        arrays = planted(96, 64, alphabet=b"ACGT" * 10 + b"acgtNnX\x00\xff")
    elif label == "a tie at two overlaps":
        # periodic reads tie at every even overlap; reads over {A, C} of up
        # to 10 bases tie often by chance
        n = 64
        per = [np.frombuffer(b"AC" * 20, np.uint8)[:k] for k in
               rng.integers(8, 40, n // 2)]
        r1 = per + [rng.choice(np.frombuffer(b"AC", np.uint8), k)
                    for k in rng.integers(4, 11, n // 2)]
        r2 = ([_MERGE_COMP[p[::-1]] for p in per]
              + [rng.choice(np.frombuffer(b"GT", np.uint8), k)
                 for k in rng.integers(4, 11, n // 2)])
        arrays = _mate_rows(rng, r1, 40) + _mate_rows(rng, r2, 40)
        kw["min_overlap"] = 2
    elif label.startswith("L = ") and label[4:].isdigit():
        L = int(label[4:])
        arrays = planted(64, L, lens=(0, L + 3))
    elif label == "n = 0":
        arrays = planted(0, 64)
    elif label == "int64 lengths":
        arrays = list(planted(64, 64))
        arrays[2], arrays[5] = (arrays[i].astype(np.int64) for i in (2, 5))
        arrays = tuple(arrays)
    elif label == MERGE_CARD_CASES[0]:
        # the merge command's batch: 150 bp mates of 200 bp fragments
        n = MERGE_BATCH
        arrays = planted(n, 256, lens=(READ_LEN, READ_LEN + 1),
                         overlap=np.full(n, 2 * READ_LEN - FRAG_LEN),
                         errors=rng.integers(0, 3, n))
    elif label in MERGE_CARD_CASES[1:3] + MERGE_CARD_CASES[4:]:
        L = int(label.split("L = ")[1].replace(",", ""))
        arrays = planted(6, L, lens=(L - 1200, L + 200),
                         overlap=rng.integers(500, 2500, 6))
    elif label == MERGE_CARD_CASES[3]:
        n = MERGE_BATCH
        arrays = planted(n, 384, lens=(300, 301),
                         overlap=600 - rng.integers(450, 551, n),
                         errors=rng.integers(0, 3, n))
    elif label == "every byte value in R1":
        # each R1 row holds all 256 byte values (rotated), each R2 row
        # letters of either case, N and other bytes: every R1 code, the
        # code of no letter included, meets every rc(R2) letter; with no
        # penalty any match merges, so the consensus takes these bytes too
        n, L = 128, 256
        seq1 = ((np.arange(L)[None, :] + 7 * np.arange(n)[:, None]) % 256
                ).astype(np.uint8)
        r2 = rng.choice(np.frombuffer(b"ACGTNacgtn\x00\xff-*RY", np.uint8),
                        (n, L))
        len1, len2 = rng.integers(1, L + 1, n), rng.integers(1, L + 1, n)
        len1[::4] = L
        arrays = (seq1, rng.integers(33, 75, (n, L)).astype(np.uint8),
                  len1.astype(np.int32), r2,
                  rng.integers(33, 75, (n, L)).astype(np.uint8),
                  len2.astype(np.int32))
        kw.update(mismatch_penalty=0, max_mismatch_frac=1.0, min_overlap=1)
    elif label == "ties far apart at L = 256":
        # period-2 reads of 100-250 bases, R2 the reverse complement of R1,
        # then the x bases of R1 just before the last o1 = len - 2x changed:
        # the full overlap and o1 both score o1. x a multiple of 16 with
        # 4x < len - 10 puts both in one lane of the kernel's order (o_hi -
        # u for u = 0 and u = 2x, both in the upper half); other x in two
        n, L = 64, 256
        lens = rng.integers(100, 251, n)
        r1, r2 = [], []
        for i, k in enumerate(lens):
            per = np.frombuffer(b"AC" * 128, np.uint8)[:k].copy()
            r2.append(_MERGE_COMP[per[::-1]])
            x = (16 * rng.integers(1, (k - 11) // 64 + 1) if i % 2 == 0
                 else rng.integers(1, (k - 20) // 2 + 1))
            o1 = k - 2 * x
            per[k - o1 - x:k - o1] = ord("G")
            r1.append(per)
        arrays = _mate_rows(rng, r1, L) + _mate_rows(rng, r2, L)
    else:
        raise ValueError(label)
    return arrays, kw


def merge_bound(len1, len2, L):
    """bound() of one merge_pairs call at its default min_overlap (10):
    of each input row only the bytes the outputs depend on read once, its
    first min(len, L) columns in 32-byte sectors (a read longer than L
    reads column L - 1), and the lengths; the two [n, 2L] outputs and four
    int32 a pair written once; MERGE_OPS_PER_COMPARE operations a position
    compared (8 per 32-position word in the bit-sliced form), o positions
    for each feasible overlap o of each pair."""
    n = len(len1)
    lo = 10
    len1 = np.asarray(len1, np.int64)
    len2 = np.asarray(len2, np.int64)
    used = sum(2 * ((np.clip(x, 0, L) + 31) // 32 * 32)
               for x in (len1, len2))
    hi = np.minimum(np.minimum(len1, len2), L)
    hi = np.where(hi >= lo, hi, lo - 1)
    compares = int(((hi * (hi + 1) - (lo - 1) * lo) // 2).sum())
    return bound(int(used.sum()) + 8 * n + 4 * n * L + 16 * n,
                 MERGE_OPS_PER_COMPARE * compares)


# ------------------------------------------------ the CLI's device ops
# Edge cases of the CLI's device ops (csrc/trim.cu, demux.cu, tiles.cu and
# kmer.cu), shared with tests/test_torch_cli_kernels.py: each label names its
# op, and cli_op_case makes its inputs from a seed. Every trim case runs the
# TRIM_MODES whose window fits its width; every demux case each of its
# max_mismatches; every kmer case each of its k.
CLI_OP_EDGE_CASES = (
    "trim: lengths 0, negative and over L",
    "trim: bytes below the offset",
    "trim: all-low rows",
    "trim: bwa ties",
    "trim: windows longer than the read",
    "trim: L = 12",
    "trim: L = 1",
    "trim: L = 3",
    "trim: L = 5",
    "trim: L = 13",
    "trim: L = 1,024, windows across lane segments",
    "trim: L = 2,176, windows across rounds",
    "trim: L = 1,500, windows across rounds",
    "trim: offset 64",
    "trim: offset 0",
    "trim: offset 255",
    "trim: offset 256",
    "trim: offset -5",
    "trim: offset -2^31 + 100 (Phred wraps)",
    "trim: thresholds outside 0-255",
    "demux: N in barcodes and reads",
    "demux: reads shorter than the barcode",
    "demux: ties",
    "demux: K = 1",
    "demux: 384 barcodes of 32 bases",
    "demux: odd width, lowercase and other bytes",
    "kmer: k = 1..8",
    "kmer: n_records as a tensor",
    "kmer: lengths over L and negative",
    "kmer: L = 7",
    "tiles: grouped",
    "tiles: shuffled",
    "tiles: unknown tiles and n_records",
    "tiles: no known tile",
    "tiles: T = n",
    "tiles: every row one tile",
    "tiles: negative tile numbers",
    "tiles: unknown tiles interleaved, 32,768 x 1,024",
    "kmer: poly-G and poly-A rows",
    "kmer: k = 7 and 8, every bin hit",
    "demux: barcodes of 48 bases",
    "demux: 4,096 barcodes of 16 bases",
    "demux: a barcode byte outside ACGTN")
# the card-only ones: the CLI's batch shapes (trim and tiles take 4,096
# reads padded to 256, demux 16,384 x 256), the analysis path's 65,536 x
# 256 (kmer_counts), reads up to 1 kb and up to 2 kb (trim takes rows wider
# than 1,024 columns in rounds), and each at a view 1 and 13 bytes off
# 16-byte alignment
CLI_OP_CARD_SHAPES = ((4096, 256), (16384, 256), (65536, 256), (32768, 1024),
                      (4096, 2048))
CLI_OP_VIEW_OFFSETS = (0, 1, 13)
TRIM_MODES = (
    ("clip_ends", dict(leading=3, trailing=3)),
    ("clip_ends", dict(leading=20, trailing=30)),
    ("clip_ends", dict(leading=0, trailing=41)),
    ("sliding_window_trim", dict(mean_q=15, window=4)),
    ("sliding_window_trim", dict(mean_q=25, window=12)),
    ("sliding_window_trim", dict(mean_q=20, window=1)),
    ("bwa_trim", dict(threshold=20)),
    ("bwa_trim", dict(threshold=0)),
    ("bwa_trim", dict(threshold=35)))
# trim modes whose thresholds pass the byte range (wrapping int32 sums in
# bwa_trim at 2^28 a base), and the modes of the 1,024-column case: windows
# of 33 and 100 bases and one as wide as the batch, across the lanes'
# 32-column segments
TRIM_MODES_WIDE = (
    ("clip_ends", dict(leading=-3, trailing=300)),
    ("clip_ends", dict(leading=256, trailing=-1)),
    ("clip_ends", dict(leading=-(1 << 31), trailing=(1 << 31) - 1)),
    ("sliding_window_trim", dict(mean_q=100, window=4)),
    ("sliding_window_trim", dict(mean_q=-2, window=3)),
    ("sliding_window_trim", dict(mean_q=70, window=5)),
    ("bwa_trim", dict(threshold=-5)),
    ("bwa_trim", dict(threshold=300)),
    ("bwa_trim", dict(threshold=1 << 28)),
    ("bwa_trim", dict(threshold=-(1 << 31))))
TRIM_MODES_1024 = (
    ("sliding_window_trim", dict(mean_q=20, window=33)),
    ("sliding_window_trim", dict(mean_q=20, window=100)),
    ("sliding_window_trim", dict(mean_q=21, window=1024)),
    ("sliding_window_trim", dict(mean_q=15, window=4)),
    ("bwa_trim", dict(threshold=20)),
    ("clip_ends", dict(leading=20, trailing=30)))
# the modes of the cases wider than 1,024 columns, which trim.cu takes in
# rounds of 1,024: windows that cross a round's edge, one wider than a
# round, one as wide as the narrower case (1,500) and one as the wider
# (2,176; the narrower case leaves it out)
TRIM_MODES_ROUNDS = (
    ("sliding_window_trim", dict(mean_q=20, window=33)),
    ("sliding_window_trim", dict(mean_q=20, window=100)),
    ("sliding_window_trim", dict(mean_q=22, window=1100)),
    ("sliding_window_trim", dict(mean_q=21, window=1500)),
    ("sliding_window_trim", dict(mean_q=21, window=2176)),
    ("sliding_window_trim", dict(mean_q=15, window=4)),
    ("bwa_trim", dict(threshold=20)),
    ("bwa_trim", dict(threshold=35)),
    ("clip_ends", dict(leading=20, trailing=30)),
    ("clip_ends", dict(leading=30, trailing=30)))
# Phred = byte - offset wraps in int32 for the bytes from 100 on: clip_ends
# keeps the bytes below 100 (huge Phred) and, at the second threshold,
# those from 150 on
TRIM_MODES_WRAP = (
    ("clip_ends", dict(leading=3, trailing=-(1 << 31) + 50)),
    ("clip_ends", dict(leading=(1 << 31) - 1, trailing=-(1 << 31))),
    ("sliding_window_trim", dict(mean_q=15, window=4)),
    ("bwa_trim", dict(threshold=20)))
KMER_KS = tuple(range(1, 9))


def barcode_set(K, bl, seed=0):
    """K distinct barcodes of bl bases (ACGT, an N in every 8th), sorted."""
    rng = np.random.default_rng([seed, 41, K, bl])
    out = set()
    while len(out) < K:
        codes = rng.choice(np.frombuffer(b"ACGT", np.uint8), (K, bl))
        codes[::8, bl // 2] = ord("N")
        out.update(c.tobytes() for c in codes)
    return sorted(out)[:K]


# the barcode sets the card shapes run: the CLI's 4 x 8, and two the kernel
# before took no card for (48 bases; 4,096 x 16 = 16,384 words of 4 bases)
DEMUX_CARD_SETS = (("4 x 8", DEMUX_BARCODES, (0, 1)),
                   ("8 x 48", tuple(barcode_set(8, 48)), (1,)),
                   ("4,096 x 16", tuple(barcode_set(4096, 16)), (1,)))
# the trim, tiles and kmer bounds' int32 operations a byte in length: the
# Phred subtract, a compare and an add or select (kmer: the code, a shift,
# an or and the run); demux's, a barcode and read, by the layout its set
# takes (demux_planes): bytes, a 4-byte word: a compare, an and, a popc and
# an add; planes, a 32-position word: three three-input logic operations
# (the planes' XORs ORed with the other plane), an and with the mask, a
# popc and an add (or the key's multiply-add), then three min / max
CLI_OPS_PER_BYTE = 3
DEMUX_OPS_PER_WORD = 4
DEMUX_PLANE_OPS_PER_WORD = 6
DEMUX_PLANE_OPS_PER_BARCODE = 3


def demux_planes(barcodes):
    """Whether csrc/demux.cu takes this set as bit-planes (ops/demux.py's
    rule: bl <= 256, K <= 2^20, every upper-cased byte one of ACGTN, not K
    <= 8 with bl <= 16) rather than bytes."""
    bl, K = len(barcodes[0]), len(barcodes)
    return (bl <= 256 and K <= 1 << 20 and not (K <= 8 and bl <= 16)
            and set(b"".join(bytes(b) for b in barcodes).upper())
            <= set(b"ACGTN"))


def trim_modes(L, modes=None):
    """The modes (TRIM_MODES by default) a batch of width L takes (window
    <= L)."""
    return tuple((fn, kw) for fn, kw in modes or TRIM_MODES
                 if kw.get("window", 1) <= L)


def _qual_rows(rng, n, L, lo=33, hi=75):
    return rng.integers(lo, hi, (n, L)).astype(np.uint8)


def _bases(rng, shape, alphabet=b"ACGT"):
    return rng.choice(np.frombuffer(alphabet, np.uint8), shape)


def de_bruijn(k, n):
    """A de Bruijn sequence B(k, n): k^n symbols in 0..k-1, each n-mer
    once cyclically (the standard recursive construction)."""
    a = [0] * k * n
    seq = []

    def db(t, p):
        if t > n:
            if n % p == 0:
                seq.extend(a[1:p + 1])
            return
        a[t] = a[t - p]
        db(t + 1, p)
        for j in range(a[t - p] + 1, k):
            a[t] = j
            db(t + 1, t)

    db(1, 1)
    return seq


def cli_op_case(label, seed):
    """One case of CLI_OP_EDGE_CASES: (op, arrays, options). op is "trim"
    (arrays qual, lengths; options offset), "demux" (seq, lengths;
    barcodes, max_mismatches: a tuple), "kmer" (seq, lengths; n_records,
    a tensor flag, ks) or "tiles" (tiles, qual, lengths; offset,
    n_records). The bytes past a read are random."""
    rng = np.random.default_rng([seed, 31, CLI_OP_EDGE_CASES.index(label)])
    op = label.split(":")[0]
    if op == "trim":
        n, L, off, modes = 96, 80, 33, None
        width = re.search(r"L = ([\d,]+)", label)
        if width:
            L = int(width.group(1).replace(",", ""))
        qual = _qual_rows(rng, n, L)
        lens = rng.integers(0, L + 1, n)
        if label.startswith("trim: offset") and label != "trim: offset 64":
            # every byte value; the offset named in the label
            qual = rng.integers(0, 256, (n, L)).astype(np.uint8)
            off = (-(1 << 31) + 100 if "2^31" in label
                   else int(label.split()[2]))
            if "wraps" in label:
                modes = TRIM_MODES_WRAP
        elif label == "trim: thresholds outside 0-255":
            qual = _qual_rows(rng, n, L, 0, 121)
            modes = TRIM_MODES_WIDE
        elif L >= 1024:
            # high Phred up to a drop at a random column, then low: the
            # first failing window falls anywhere in the row (past 1,024
            # columns, in any round)
            n = 64
            qual = _qual_rows(rng, n, L, 60, 76)
            drop = rng.integers(0, L, n)
            low = np.arange(L)[None, :] >= drop[:, None]
            qual[low] = _qual_rows(rng, n, L, 33, 46)[low]
            lens = rng.integers(L // 2, L + 1, n)
            lens[::2] = L
            modes = TRIM_MODES_1024 if L == 1024 else TRIM_MODES_ROUNDS
        if label == "trim: lengths 0, negative and over L":
            lens[:8] = 0
            lens[8:16] = -rng.integers(1, 40, 8)
            lens[16:24] = L + rng.integers(1, 50, 8)
            lens[24:28] = L
        elif label == "trim: bytes below the offset":
            low = rng.random((n, L)) < 0.3
            qual[low] = rng.integers(0, 33, int(low.sum()))
        elif label == "trim: all-low rows":
            qual[::2] = rng.integers(28, 36, (n // 2, L))
            qual[1::4] = 33
            lens[::3] = L
        elif label == "trim: bwa ties":
            # Phred 10 and 30 only: with threshold 20 the running sums step
            # by +-10, so equal maxima at several k are the rule
            qual = np.where(rng.random((n, L)) < 0.5, 43, 63).astype(np.uint8)
            qual[::4, ::2] = 43
            qual[::4, 1::2] = 63
        elif label == "trim: windows longer than the read":
            lens = rng.integers(0, 14, n)
        elif label == "trim: offset 64":
            off = 64
            qual = _qual_rows(rng, n, L, 40, 110)
        return "trim", dict(qual=qual, lengths=lens.astype(np.int32)), dict(
            offset=off, modes=modes)
    if op == "demux":
        barcodes = [b"ACGTAC", b"TTGGCA", b"ACGTAN", b"GGGGGG", b"NNCATG"]
        n, L = 200, 64
        mms = (0, 1, 2, 7)
        if label == "demux: 384 barcodes of 32 bases":
            barcodes = [bytes(_bases(rng, 32)) for _ in range(384)]
            barcodes[7] = barcodes[3][:30] + b"NN"
        elif label == "demux: K = 1":
            barcodes = [b"GATTACAG"]
            mms = (0, 1, 9, 10)
        elif label == "demux: odd width, lowercase and other bytes":
            barcodes = [b"acgtacgtA", b"TTGGCCAAn", b"GATTACAG-"]
            L = 37
        elif label == "demux: barcodes of 48 bases":
            barcodes = [bytes(_bases(rng, 48)) for _ in range(8)]
            barcodes[5] = barcodes[2][:40] + b"NNNNNNNN"
            barcodes[6] = b"n" + barcodes[6][1:].lower()
        elif label == "demux: 4,096 barcodes of 16 bases":
            barcodes = barcode_set(4096, 16, seed)
            L, mms = 40, (0, 1, 2)
        elif label == "demux: a barcode byte outside ACGTN":
            # '@', 'Z', 0xC1 and 0x0D match the read bytes that & 0xDF
            # makes them ('z' and 0xE1 too); '-' matches no read byte
            barcodes = [bytes(_bases(rng, 40)) for _ in range(6)]
            for i, b in enumerate(b"@Z\xc1\x0d-R"):
                barcodes[i] = (barcodes[i][:3 + 5 * i] + bytes([b])
                               + barcodes[i][4 + 5 * i:])
            L = 48
        bl = len(barcodes[0])
        seq = _bases(rng, (n, L), b"ACGTNacgtn")
        lens = rng.integers(bl, L + 1, n)
        # most reads start with a barcode, some with errors
        pick = rng.integers(0, len(barcodes), n)
        for i in range(n):
            if i % 5:
                bc = np.frombuffer(barcodes[pick[i]].upper().replace(
                    b"N", b"A"), np.uint8).copy()
                for _ in range(rng.integers(0, 3)):
                    bc[rng.integers(0, bl)] = _bases(rng, 1, b"ACGTNacgt")[0]
                seq[i, :bl] = bc
        if label == "demux: reads shorter than the barcode":
            lens[::2] = rng.integers(-3, bl, (n + 1) // 2)
        elif label == "demux: ties":
            # reads one base from two barcodes at once
            seq[::2, :bl] = np.frombuffer(b"ACGTGC", np.uint8)
        elif label == "demux: odd width, lowercase and other bytes":
            seq[::7, 3] = ord("-")
            seq[1::7] = _bases(rng, (len(seq[1::7]), L), b"acgtn-\x00\xff")
        elif label == "demux: a barcode byte outside ACGTN":
            seq[1::3, 8] = np.frombuffer(b"zZ\xe1\xc1@", np.uint8)[
                rng.integers(0, 5, len(seq[1::3]))]
        return "demux", dict(seq=seq, lengths=lens.astype(np.int32)), dict(
            barcodes=barcodes, max_mismatches=mms)
    if op == "kmer":
        n, L = 48, 40
        if label == "kmer: L = 7":
            L = 7
        elif label == "kmer: poly-G and poly-A rows":
            n, L = 64, 150
        seq = _bases(rng, (n, L), b"ACGTacgt" * 3 + b"Nn-X")
        lens = rng.integers(0, L + 1, n)
        n_records, ks = 41, (2, 5, 8)
        if label == "kmer: poly-G and poly-A rows":
            # whole rows of one base, either case, and poly-G tails
            seq[::4] = ord("G")
            seq[1::4] = ord("A")
            seq[2::4] = _bases(rng, (len(seq[2::4]), L), b"Gg")
            for i in range(3, n, 4):
                seq[i, rng.integers(0, L):] = ord("G")
            lens[::5] = L + 10
            n_records, ks = None, (1, 4, 7, 8)
        elif label == "kmer: k = 7 and 8, every bin hit":
            # rows that hold every 8-mer: a de Bruijn sequence B(4, 8) cut
            # into rows that overlap by 7 bases, half of them lower case
            cyc = np.frombuffer(b"ACGT", np.uint8)[de_bruijn(4, 8)]
            L = 272
            starts = np.arange(0, len(cyc), L - 7)
            seq = cyc[(starts[:, None] + np.arange(L)[None, :]) % len(cyc)]
            seq[::2] |= 0x20
            n = len(seq)
            lens = np.full(n, L)
            n_records, ks = None, (7, 8)
        if label == "kmer: k = 1..8":
            n_records, ks = None, KMER_KS
        elif label == "kmer: lengths over L and negative":
            lens[::5] = L + rng.integers(1, 9, len(lens[::5]))
            lens[1::5] = -rng.integers(1, 9, len(lens[1::5]))
            n_records = n
        elif label == "kmer: L = 7":
            ks = (1, 7, 8)
        return "kmer", dict(seq=seq, lengths=lens.astype(np.int32)), dict(
            n_records=n_records, tensor=label.endswith("tensor"), ks=ks)
    if op == "tiles":
        n, L, n_records = 160, 72, None
        tiles = np.repeat(np.array([1101, 1102, 2101, 2102], np.int32),
                          n // 4)
        if label == "tiles: shuffled":
            tiles = rng.permutation(tiles)
        elif label == "tiles: unknown tiles and n_records":
            tiles[rng.integers(0, n, 30)] = -1
            n_records = 123
        elif label == "tiles: no known tile":
            tiles[:] = -1
        elif label == "tiles: T = n":
            # a tile a row: more tiles than one block's shared memory holds
            n, L = 4096, 40
            tiles = (1000 + rng.permutation(n)).astype(np.int32)
        elif label == "tiles: every row one tile":
            tiles[:] = 2101
        elif label == "tiles: negative tile numbers":
            # unknown, as -1 is: each row of them sums into no tile
            tiles = rng.permutation(tiles)
            tiles[::3] = rng.choice(np.array(
                [-2, -7, -100000, -(1 << 31), -1], np.int32), len(tiles[::3]))
        elif label.startswith("tiles: unknown tiles interleaved"):
            n, L, n_records = 32768, 1024, 32768 - 100
            tiles = rng.choice(np.array(TILES + (-1,), np.int32), n)
            tiles[::3] = -1
        qual = _qual_rows(rng, n, L, 0, 120)
        lens = rng.integers(-5, L + 20, n)
        return "tiles", dict(tiles=tiles, qual=qual,
                             lengths=lens.astype(np.int32)), dict(
            offset=33, n_records=n_records)
    raise ValueError(label)


def cli_op_card_batch(op, n, L, seed, barcodes=DEMUX_BARCODES):
    """A batch of the CLI ops' card shapes: arrays as cli_op_case gives
    them, reads of L / 2 to L bases (some longer than L, some empty); demux
    reads start with one of `barcodes` (a third with a base set to A)."""
    rng = np.random.default_rng([seed, 37, n, L])
    lens = rng.integers(L // 2, L + 1, n)
    lens[::97] = 0
    lens[1::89] = L + 10
    qual = _qual_rows(rng, n, L, 33, 75)
    if op == "trim":
        return dict(qual=qual, lengths=lens.astype(np.int32))
    seq = _bases(rng, (n, L), b"ACGT" * 8 + b"N")
    if op == "tiles":
        tiles = np.repeat(np.array(TILES, np.int32), -(-n // len(TILES)))[:n]
        return dict(tiles=tiles, qual=qual, lengths=lens.astype(np.int32))
    if op == "demux":
        bl = len(barcodes[0])
        pick = rng.integers(0, len(barcodes), n)
        seq[:, :bl] = np.frombuffer(b"".join(barcodes).replace(b"N", b"A"),
                                    np.uint8).reshape(-1, bl)[pick]
        seq[::3, rng.integers(0, bl)] = ord("A")
    return dict(seq=seq, lengths=lens.astype(np.int32))


def cli_op_calls(op, d, kw):
    """The calls a case of op makes on `d` (its arrays as tensors on one
    device; tiles stays numpy), each (name, the dispatching op, its plain
    torch version) as functions of no argument that return a tuple."""
    import functools

    import torch

    from blazeseq_tpu_torch.ops import demux, kmer, tiles, trim

    def pair(mod, fn, *a, **k):
        return (functools.partial(getattr(mod, fn), *a, **k),
                functools.partial(getattr(mod, fn + "_torch"), *a, **k))

    def as_tuple(f):
        return lambda: (lambda r: r if isinstance(r, tuple) else (r,))(f())

    calls = []
    if op == "trim":
        for fn, fkw in trim_modes(d["qual"].shape[1], kw.get("modes")):
            name = "%s(%s)" % (fn, ", ".join("%s=%s" % x for x in
                                             fkw.items()))
            calls.append((name,) + pair(trim, fn, d["qual"], d["lengths"],
                                        kw["offset"], **fkw))
    elif op == "demux":
        for mm in kw["max_mismatches"]:
            calls.append(("demux_assign(max_mismatches=%d)" % mm,)
                         + pair(demux, "demux_assign", d["seq"],
                                d["lengths"], kw["barcodes"], mm))
    elif op == "kmer":
        nr = kw["n_records"]
        if kw.get("tensor"):
            nr = torch.tensor(nr, dtype=torch.int32, device=d["seq"].device)
        for k in kw["ks"]:
            calls.append(("kmer_counts(k=%d)" % k,)
                         + pair(kmer, "kmer_counts", d["seq"], d["lengths"],
                                nr, k=k))
    elif op == "tiles":
        calls.append(("per_tile_qual_sums",)
                     + pair(tiles, "per_tile_qual_sums", d["tiles"],
                            d["qual"], d["lengths"], kw["offset"],
                            n_records=kw["n_records"]))
    else:
        raise ValueError(op)
    return [(name, as_tuple(f), as_tuple(g)) for name, f, g in calls]


def cli_op_tensors(arrays, device, view=0):
    """The case's arrays as tensors on `device` (tiles stays numpy); with
    view > 0 the u8 rows are a contiguous view that starts `view` bytes
    into a larger buffer."""
    import torch

    out = {}
    for k, a in arrays.items():
        if k == "tiles":
            out[k] = a
        elif a.dtype == np.uint8 and view:
            buf = torch.zeros(a.size + view, dtype=torch.uint8, device=device)
            out[k] = buf[view:].view(a.shape)
            out[k].copy_(torch.from_numpy(a))
        else:
            out[k] = torch.from_numpy(a).to(device)
    return out


def same_leaves(got, want, label):
    """Leaf-by-leaf equality of two results (tensors or numpy arrays):
    shapes, dtypes and values; returns the largest |difference| (0)."""
    import torch

    def host(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else x

    if len(got) != len(want):
        raise AssertionError("%s: %d leaves, want %d"
                             % (label, len(got), len(want)))
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = host(g), host(w)
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError("%s: leaf %d is %s %s, want %s %s"
                                 % (label, i, g.dtype, g.shape, w.dtype,
                                    w.shape))
        if not np.array_equal(g, w):
            d = np.abs(g.astype(np.float64) - w.astype(np.float64))
            raise AssertionError("%s: leaf %d differs from its plain version "
                                 "by up to %g" % (label, i, np.nanmax(d)))
    return 0


def cli_op_bound(op, arrays, **kw):
    """bound() of one call of a CLI op on these arrays (numpy): each row's
    bytes in length read once (demux: its first bl; tiles: of the rows of
    known tiles), the lengths (and tiles' row map) read once, the outputs
    written once (tiles: float32 sums and counts); CLI_OPS_PER_BYTE
    int32 operations a byte in length; demux, a barcode and read,
    DEMUX_OPS_PER_WORD a 4-byte word of a set taken as bytes, or
    DEMUX_PLANE_OPS_PER_WORD a 32-position word and
    DEMUX_PLANE_OPS_PER_BARCODE of one taken as planes."""
    lens = arrays["lengths"].astype(np.int64)
    n = len(lens)
    L = (arrays.get("qual") if "qual" in arrays else arrays["seq"]).shape[1]
    used = np.clip(lens, 0, L)
    if op == "demux":
        bcs = kw["barcodes"]
        bl, K = len(bcs[0]), len(bcs)
        if demux_planes(bcs):
            words = -(-bl // 32)
            ops = (DEMUX_PLANE_OPS_PER_WORD * words
                   + DEMUX_PLANE_OPS_PER_BARCODE)
            set_bytes = 16 * K * words
        else:
            words = -(-bl // 4)
            ops = DEMUX_OPS_PER_WORD * words
            set_bytes = 8 * K * words
        return bound(n * bl + 4 * n + 8 * n + set_bytes, ops * n * K)
    if op == "tiles":
        known = arrays["tiles"] >= 0
        T = max(len(np.unique(arrays["tiles"][known])), 1)
        b = int(used[known].sum())
        return bound(b + 8 * n + 2 * 4 * T * L, CLI_OPS_PER_BYTE * b)
    if op == "kmer":
        b = int(used.sum())
        return bound(b + 4 * n + 4 * 4 ** kw["k"], CLI_OPS_PER_BYTE * b)
    b = int(used.sum())  # trim
    out = 8 if kw.get("mode") == "clip_ends" else 4
    return bound(b + 4 * n + out * n, CLI_OPS_PER_BYTE * b)


def check_report(rep, oracle, width):
    """Every report panel against the oracle; raises on the first
    mismatch. A uniform block's oracle holds its READ_LEN columns; a
    window oracle (_window_oracle) also holds the per-position read count,
    the true bases and the length histogram."""
    n = oracle["reads"]
    L = oracle["base_pp"].shape[1]
    base_pp = np.zeros((5, width), np.int64)
    base_pp[:, :L] = oracle["base_pp"]
    count = np.zeros(width, np.int64)
    count[:L] = oracle.get("count", n)
    qual_pp = np.zeros(width, np.int64)
    qual_pp[:L] = oracle["qual_pp"]
    length_hist = oracle.get("length_hist")
    if length_hist is None:
        length_hist = np.zeros(512, np.int64)
        length_hist[READ_LEN] = n
    base_counts = base_pp.sum(1)
    bases = oracle.get("bases", n * READ_LEN)
    want = dict(
        reads=n, bases=bases, error_reads=0, base_counts=base_counts,
        per_pos_base_counts=base_pp, per_pos_count=count,
        qual_hist=oracle["qual_hist"], length_hist=length_hist,
        gc_hist=oracle["gc_hist"], mean_qual_hist=oracle["mq_hist"],
        per_position_mean_quality=qual_pp / np.maximum(count, 1),
        gc_fraction=float(base_counts[1] + base_counts[2]) / bases,
        mean_quality=float(np.sum(oracle["qual_hist"] * np.arange(64)))
        / bases,
    )
    for k, v in want.items():
        got = getattr(rep, k)
        if not np.array_equal(np.asarray(got), np.asarray(v)):
            raise AssertionError("report panel %s differs from the oracle: "
                                 "%r vs %r" % (k, got, v))


# ------------------------------------------------------------- timing

def cuda_ms(fn, inner=10, trials=5):
    """Device milliseconds per fn() call: the median over `trials` of
    CUDA-event timings of `inner` back-to-back calls, after a warm-up."""
    import torch

    fn()
    times = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return float(np.median(times))


def bound(n_bytes, ops):
    """bound_ms / bound_by of a kernel call that must move `n_bytes` and do
    `ops` int32 operations on this card."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = ops / (sms * INT32_LANES_PER_SM * BOOST_CLOCK_HZ)
    return dict(bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors):
    """Bytes of the tensors (None skipped): each read or written once."""
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def max_abs_diff(xs, ys, label):
    """Largest |x - y| over paired integer tensors (None pairs skipped);
    raises when it is not 0."""
    import torch

    err = 0
    for x, y in zip(xs, ys):
        if x is None and y is None:
            continue
        if x.shape != y.shape:
            raise AssertionError("%s: shapes differ, %s vs %s"
                                 % (label, tuple(x.shape), tuple(y.shape)))
        d = (x.to(torch.int64) - y.to(torch.int64)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    if err:
        raise AssertionError("%s: kernel differs from its plain version by "
                             "up to %d" % (label, err))
    return err


# ------------------------------------------------------------- phases

def phase_card():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA card; "
                           "torch.cuda.is_available() is False")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log("card:", name, "| count:", torch.cuda.device_count(), "|", smi)
    log("torch", torch.__version__, "| cuda", torch.version.cuda,
        "| python", sys.version.split()[0])
    return name, smi


def phase_build():
    """Build the CUDA kernels and, beside them, the host libraries that
    native/ compiles with g++ at first use (the record scanner with the id
    normalizer, and the record extension), so that no timed path pays for
    a compile."""
    from blazeseq_tpu_torch import _kernels, native

    t0 = time.perf_counter()
    with cf.ThreadPoolExecutor(2) as ex:
        host = [ex.submit(native.has_native), ex.submit(native.records_ext)]
        _kernels.load()
        cuda_s = time.perf_counter() - t0
        scan_ok, records = (f.result() for f in host)
    log("build + load of %s: %.2f s; host libraries: scanner %s, record "
        "extension %s, both ready at %.2f s" % (
            ", ".join(_kernels.SOURCES), cuda_s,
            "built" if scan_ok else "missing (numpy fallback)",
            "built" if records is not None else "missing",
            time.perf_counter() - t0))


def kernel_a_inputs(rng, n, L):
    """seq, qual u8[n, L] and lengths i32[n] for kernel A: high-bit bytes,
    out-of-range (and wrapping) quality bytes, lengths from 0 to past L."""
    seq = _SEQ_LUT[rng.integers(0, 256, (n, L))]
    qual = rng.integers(33, 75, (n, L), dtype=np.uint8)
    k = max(1, n // 100)
    seq[rng.integers(0, n, k), rng.integers(0, L, k)] |= 0x80
    qual[rng.integers(0, n, k), rng.integers(0, L, k)] |= 0x80
    qual[rng.integers(0, n, 2 * k), rng.integers(0, L, 2 * k)] = 20
    qual[rng.integers(0, n, 2 * k), rng.integers(0, L, 2 * k)] = 100
    lengths = rng.integers(0, L + 64, n).astype(np.int32)
    lengths[:16] = 0
    lengths[16:32] = L + 500
    return seq, qual, lengths


def kernel_a_bound(lengths, L, col_offset=0):
    """bound() of one kernel A call on these lengths: seq and qual read
    only where a row's length reaches (the rest need not be read), phred
    written whole, lengths and codes; a range test, a high-bit test and the
    subtract per byte."""
    n = len(lengths)
    inlen = np.clip(lengths.astype(np.int64) - col_offset, 0, L).sum()
    return bound(2 * int(inlen) + n * L + 8 * n, 5 * n * L)


# kernel A's timed shapes, each a "validate_decode" record of the JSON line:
# the padded batch of run_file (4,096 x max_read_len 256), and a batch of
# reads up to 1 kb at 8x the batch size, where device memory bounds it
KERNEL_A_SHAPES = ((4096, 256), (32768, 1024))


def phase_kernel_a(seed):
    """Kernel A (validate) against its plain version on the card, exact:
    both shapes of KERNEL_A_SHAPES and L = 384 (col_offset 0 and 128,
    three flag pairs), then edge batches (L = 1, 17, 100 and 513 and rows
    one byte off alignment, on the byte path; lengths -5..L+9, col_offset
    L + 3, quality bytes at the bounds and at 0x7F / 0x80 / 0xFF). Returns
    one JSON record per shape, timed on the aligned inputs."""
    import torch

    from blazeseq_tpu_torch import parse_schema
    from blazeseq_tpu_torch.ops.validate import (lane_group, validate_decode,
                                                 validate_decode_torch)

    rng = np.random.default_rng([seed, 1])
    schema = parse_schema("sanger")
    err = 0
    n_cases = 0

    def compare(dseq, dqual, dlen, label, **kw):
        nonlocal err, n_cases
        got = validate_decode(dseq, dqual, dlen, schema, **kw)
        want = validate_decode_torch(dseq, dqual, dlen, schema.LOWER,
                                     schema.UPPER, schema.OFFSET, **kw)
        torch.cuda.synchronize()
        err = max(err, max_abs_diff(got, want, "kernel A, %s %r"
                                    % (label, kw)))
        n_cases += 1

    out = []
    for n, L in KERNEL_A_SHAPES + ((4096, 384),):
        seq, qual, lengths = kernel_a_inputs(rng, n, L)
        dseq, dqual, dlen = (torch.from_numpy(a).cuda()
                             for a in (seq, qual, lengths))
        for col_offset in (0, 128):
            for ca, cq in ((True, True), (True, False), (False, True)):
                compare(dseq, dqual, dlen, "[%d, %d]" % (n, L),
                        check_ascii=ca, check_quality=cq,
                        col_offset=col_offset)
        if (n, L) not in KERNEL_A_SHAPES:
            continue
        group = lane_group(L, dseq.data_ptr(), dqual.data_ptr())
        ms = cuda_ms(lambda: validate_decode(dseq, dqual, dlen, schema))
        plain_ms = cuda_ms(lambda: validate_decode_torch(
            dseq, dqual, dlen, schema.LOWER, schema.UPPER, schema.OFFSET),
            inner=2)
        bnd = kernel_a_bound(lengths, L)
        log("kernel A [%d, %d] (%d lanes a row): kernel %.4f ms, plain "
            "%.4f ms, bound %.5f ms (%s)" % (n, L, group, ms, plain_ms,
                                             bnd["bound_ms"],
                                             bnd["bound_by"]))
        out.append(dict(shape=[n, L], ms=ms, plain_ms=plain_ms, **bnd))
        del dseq, dqual, dlen
    for L in (1, 17, 100, 513, 256):
        n = 3000
        seq, qual, lengths = kernel_a_inputs(rng, n, L)
        lengths[32:37] = (-5, -1, 1, L, L + 9)
        edges = np.array([33, 126, 0x7F, 0x80, 0xFF, 32, 127], np.uint8)
        qual[np.arange(40, 47), rng.integers(0, L, 7)] = edges
        dlen = torch.from_numpy(lengths).cuda()
        for off in (0, 1):  # rows 16-byte aligned, or one byte off
            flat = [torch.zeros(n * L + off, dtype=torch.uint8,
                                device="cuda") for _ in range(2)]
            for f, a in zip(flat, (seq, qual)):
                f[off:].copy_(torch.from_numpy(a.reshape(-1)))
            dseq, dqual = (f[off:].view(n, L) for f in flat)
            for col_offset in (0, 7, L + 3):
                for ca, cq in ((True, True), (True, False), (False, True),
                               (False, False)):
                    compare(dseq, dqual, dlen, "L=%d off=%d" % (L, off),
                            check_ascii=ca, check_quality=cq,
                            col_offset=col_offset)
    log("kernel A == plain on %d cases" % n_cases)
    for rec in out:
        rec["max_abs_err"] = err
    return out


# the panels' timed batch: run_file's padded batch (4,096 x max_read_len
# 256); qc_stats also with the quartile leaf and at 32,768 x 1,024
PANEL_SHAPE = (4096, 256)
PANEL_WIDE = (32768, 1024)
PANEL_EDGE_WIDTHS = (1, 7, 16, 33, 256, 1024)
# a batch tall enough that qc_stats' blocks take their most rows (512)
PANEL_TALL = (300_000, 16)
# FastQC's adapter list, and the adapter sets of the multi-adapter kernel:
# none, one, the six, and the six with one longer than most rows and one in
# lower case
FASTQC_ADAPTERS = (b"AGATCGGAAGAG", b"TGGAATTCTCGG", b"GATCGTCGGACT",
                   b"CTGTCTCTTATA", b"AAAAAAAAAAAA", b"GGGGGGGGGGGG")
ADAPTER_SETS = ((), (ADAPTER,), FASTQC_ADAPTERS,
                FASTQC_ADAPTERS + (b"ACGT" * 70, b"tggaattctcgg"))
# (count_scalars, row_stats, qual_hist_2d)
QC_STATS_OPTIONS = ((True, True, False), (False, True, False),
                    (True, False, False), (True, True, True))


def panel_inputs(rng, n, L, offset=33):
    """seq, qual, lengths and codes of a padded batch for the panel
    kernels: kernel A's bytes and lengths (0 to past L), quality bytes
    below the offset and past offset + 63, the adapter planted in every
    eighth row (every sixteenth in lower case), codes drawn from 0, 4, 5."""
    seq, qual, lengths = kernel_a_inputs(rng, n, L)
    k = max(2, n * L // 50)
    qual.flat[rng.integers(0, n * L, k)] = rng.choice(
        np.array([0, offset - 1, offset + 63, offset + 64, 0xFF], np.uint8),
        k)
    a = np.frombuffer(ADAPTER, np.uint8)
    if L > len(a):
        for r in range(0, n, 8):
            j = int(rng.integers(0, L - len(a) + 1))
            seq[r, j:j + len(a)] = a | (0x20 if r % 16 == 8 else 0)
    codes = rng.choice(np.array([0] * 8 + [4, 5], np.int32), n)
    return seq, qual, lengths, codes


def qc_stats_bound(lengths, L, n_valid, qual_hist_2d, col_offset=0):
    """bound() of one qc_stats call: seq and qual read where a record's
    length reaches, lengths and codes of the records, the leaves written
    once."""
    inlen = int(np.clip(lengths[:n_valid].astype(np.int64) - col_offset, 0,
                        L).sum())
    # the QCStats leaves: 750 values beside 7 a column (the quartile leaf
    # 64 more a column)
    leaves = 750 + 7 * L + (64 * L if qual_hist_2d else 0)
    return bound(2 * inlen + 8 * n_valid + 4 * leaves,
                 QC_STATS_OPS_PER_POSITION * inlen)


def adapter_bound(seq, lengths, n_valid, adapters):
    """bound() of one call that scans this data for `adapters`: each record
    read up to the end of the last adapter's first hit (to its length when
    one has none), one compare per start column and adapter up to its
    first hit, lengths and the panels."""
    import torch

    from blazeseq_tpu_torch.ops.adapter import _adapter_matches

    n, L = seq.shape
    fit = lengths[:n_valid].clamp(0, L).to(torch.int64)
    read = torch.zeros_like(fit)
    starts = 0
    for adapter in adapters:
        la = len(adapter)
        hit = _adapter_matches(seq[:n_valid], lengths[:n_valid], adapter)
        any_hit = hit.any(1)
        first = hit.to(torch.int32).argmax(1).to(torch.int64)
        starts += int(torch.where(any_hit, first + 1,
                                  (fit - la + 1).clamp(min=0)).sum())
        read = torch.maximum(read, torch.where(any_hit, first + la, fit))
    return bound(int(read.sum()) + 4 * n_valid + 4 * len(adapters) * (L + 2),
                 starts)


def launch_floor_ms():
    """Device ms of an empty launch (torch.cuda._sleep(0)), queued behind a
    sleeping kernel so that the host's launch cost is hidden: the least a
    kernel launch takes on this card."""
    import torch

    times = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        a.record()
        for _ in range(50):
            torch.cuda._sleep(0)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / 50)
    return float(np.median(times))


def hash_bound(lengths, L, n, n_valid):
    """bound() of one read_hashes call: each record read up to its length
    (clipped to L), the lengths, 16 bytes written a row."""
    inlen = int(np.clip(lengths[:n_valid], 0, L).astype(np.int64).sum())
    return bound(inlen + 4 * n + 16 * n, HASH_OPS_PER_BYTE * inlen)


def _card_rows(a, off):
    """`a` on the card as a contiguous view `off` bytes into its storage
    (off 1: rows off 4-byte alignment, the kernels' byte path)."""
    import torch

    flat = torch.empty(a.size + off, dtype=torch.uint8, device="cuda")
    flat[off:].copy_(torch.from_numpy(a.reshape(-1)))
    return flat[off:].view(a.shape)


def phase_padded_panels(seed):
    """The padded-batch panel kernels against their plain versions on the
    card, bit for bit: qc_stats (csrc/qc_stats.cu), adapter_content and the
    multi-adapter scan _adapter_contents (csrc/adapter.cu) and read_hashes
    (csrc/dedup.cu). At PANEL_SHAPE with every option set of qc_stats and at
    PANEL_WIDE with the quartile leaf; then edge batches of 300 rows at
    PANEL_EDGE_WIDTHS, rows aligned and one byte off, offsets 33 and 64,
    n_records n, in between and 0 (col_offset 5 and no codes in between),
    every option set, adapters of 0, 1 and 12 bytes, the adapter sets of
    ADAPTER_SETS in one launch each, the hashes also into a larger sample
    (every row, a cut, one row; at 0 and 7) and with negative lengths, and
    PANEL_TALL; and the running totals:
    three batches added into one qc_stats out= (every option set) and one
    _adapter_contents out= (every adapter set) against the sums of the plain
    versions. Returns one JSON record per kernel, timed at PANEL_SHAPE with
    n_records = n (qc_stats with the default options; with the quartile leaf,
    at PANEL_WIDE and into a running total under `variants`; the adapter
    kernel with ADAPTER, and with FASTQC_ADAPTERS in one launch under
    `variants`; read_hashes into a sample buffer, with the call that
    returns a new tensor beside it and PANEL_WIDE under `variants`), each
    with the launch floor beside it."""
    import torch

    from blazeseq_tpu_torch.ops import adapter as ad
    from blazeseq_tpu_torch.ops import dedup
    from blazeseq_tpu_torch.ops import stats

    rng = np.random.default_rng([seed, 43])
    n_cases = 0

    def same(got, want, label):
        nonlocal n_cases
        torch.cuda.synchronize()
        max_abs_diff(got, want, label)
        n_cases += 1

    def contents(dseq, dlen, nr, adapters, out=None):
        got = ad._adapter_contents(dseq, dlen, nr, adapters, out=out)
        if len(got) != len(adapters):
            raise AssertionError("_adapter_contents: %d panels for %d "
                                 "adapters" % (len(got), len(adapters)))
        return got

    def compare_all(dseq, dqual, dlen, dcodes, offset, label):
        n = dseq.shape[0]
        for nr, codes, col in ((n, dcodes, 0), (n // 2 + 1, None, 5),
                               (0, dcodes, 0)):
            for cs, rs, q2 in QC_STATS_OPTIONS:
                kw = dict(n_records=nr, error_codes=codes, col_offset=col,
                          count_scalars=cs, row_stats=rs, qual_hist_2d=q2)
                same(stats.qc_stats(dseq, dqual, dlen, offset, **kw),
                     stats.qc_stats_torch(dseq, dqual, dlen, offset, **kw),
                     "qc_stats %s %r" % (label, kw))
            for adapter in (b"", b"C", ADAPTER):
                same(ad.adapter_content(dseq, dlen, nr, adapter_host=adapter),
                     ad.adapter_content_torch(dseq, dlen, nr,
                                              adapter_host=adapter),
                     "adapter_content %s %r n_records %d"
                     % (label, adapter, nr))
            for adapters in ADAPTER_SETS:
                got = contents(dseq, dlen, nr, adapters)
                for a, g in zip(adapters, got):
                    same(g, ad.adapter_content_torch(dseq, dlen, nr,
                                                     adapter_host=a),
                         "_adapter_contents %s %d adapters, %r n_records %d"
                         % (label, len(adapters), a, nr))
            compare_hashes(dseq, dlen, nr, label)

    def compare_hashes(dseq, dlen, nr, label):
        """read_hashes, and _read_hashes_into a larger sample (every row, a
        cut, one row; at 0 and 7), against read_hashes_torch."""
        plain = dedup.read_hashes_torch(dseq, dlen, nr)
        same((dedup.read_hashes(dseq, dlen, nr),), (plain,),
             "read_hashes %s n_records %d" % (label, nr))
        n = dseq.shape[0]
        for rows, at in ((n, 0), (n // 2 + 1, 7), (1, 7)):
            got = torch.full((at + rows + 3, 2), -5, dtype=torch.int64,
                             device="cuda")
            want = got.clone()
            want[at:at + rows] = plain[:rows]
            dedup._read_hashes_into(dseq, dlen, nr, got, at, rows)
            same((got,), (want,), "_read_hashes_into %s n_records %d, "
                 "rows %d at %d" % (label, nr, rows, at))

    def compare_totals(batches, label):
        """Three batches added into one out against the plain sums."""
        for cs, rs, q2 in QC_STATS_OPTIONS:
            total = want = None
            for (dseq, dqual, dlen, dcodes, offset), nr in zip(
                    batches, (None, 7, 0)):
                kw = dict(n_records=nr, error_codes=dcodes, count_scalars=cs,
                          row_stats=rs, qual_hist_2d=q2)
                total = stats.qc_stats(dseq, dqual, dlen, offset, out=total,
                                       **kw)
                part = stats.qc_stats_torch(dseq, dqual, dlen, offset, **kw)
                want = part if want is None else want.merge(part)
            same(total, want, "qc_stats(out=) %s, 3 batches, options %r"
                 % (label, (cs, rs, q2)))
        for adapters in ADAPTER_SETS:
            total, want = None, [None] * len(adapters)
            for (dseq, _, dlen, _, _), nr in zip(batches, (None, 7, 0)):
                total = contents(dseq, dlen, nr, adapters, out=total)
                want = [ad.adapter_content_torch(dseq, dlen, nr,
                                                 adapter_host=a)
                        if w is None else w.merge(ad.adapter_content_torch(
                            dseq, dlen, nr, adapter_host=a))
                        for w, a in zip(want, adapters)]
            for a, g, w in zip(adapters, total, want):
                same(g, w, "_adapter_contents(out=) %s, 3 batches, %r"
                     % (label, a))

    floor = launch_floor_ms()
    log("launch floor: an empty launch takes %.5f ms on the card alone "
        "(launch_floor_ms)" % floor)
    variants = {}
    ad_variants = {}
    recs = {}
    for (n, L), offsets in ((PANEL_SHAPE, (33, 64)), (PANEL_WIDE, (33,))):
        batches = []
        for offset in offsets:
            seq, qual, lengths, codes = panel_inputs(rng, n, L, offset)
            d = [torch.from_numpy(a).cuda()
                 for a in (seq, qual, lengths, codes)]
            compare_all(*d, offset, "[%d, %d] offset %d" % (n, L, offset))
            batches.append((*d, offset))
        if (n, L) == PANEL_SHAPE:
            compare_totals(batches + batches[:1], "[%d, %d]" % (n, L))
        tag = "%dx%d" % (n, L)
        for q2 in ((False, True) if (n, L) == PANEL_SHAPE else (True,)):
            def kern(out=None):
                return stats.qc_stats(d[0], d[1], d[2], 33, n_records=n,
                                      error_codes=d[3], qual_hist_2d=q2,
                                      out=out)

            def plain():
                return stats.qc_stats_torch(d[0], d[1], d[2], 33,
                                            n_records=n, error_codes=d[3],
                                            qual_hist_2d=q2)

            rec = dict(shape=[n, L], ms=cuda_ms(kern),
                       plain_ms=cuda_ms(plain, inner=2),
                       launch_floor_ms=floor,
                       **qc_stats_bound(lengths, L, n, q2))
            if (n, L) == PANEL_SHAPE and not q2:
                recs["qc_stats"] = rec
                total = kern()
                variants[tag + "_out"] = dict(
                    rec, ms=cuda_ms(lambda: kern(total)))
            else:
                variants[tag + ("_qual_hist_2d" if q2 else "")] = rec
        if (n, L) == PANEL_SHAPE:
            recs["adapter_content"] = dict(
                shape=[n, L],
                ms=cuda_ms(lambda: ad.adapter_content(
                    d[0], d[2], n, adapter_host=ADAPTER)),
                plain_ms=cuda_ms(lambda: ad.adapter_content_torch(
                    d[0], d[2], n, adapter_host=ADAPTER), inner=2),
                launch_floor_ms=floor,
                **adapter_bound(d[0], d[2], n, (ADAPTER,)))
            ad_variants["adapters_6"] = dict(
                shape=[n, L], adapters=len(FASTQC_ADAPTERS),
                ms=cuda_ms(lambda: ad._adapter_contents(
                    d[0], d[2], n, FASTQC_ADAPTERS)),
                plain_ms=cuda_ms(lambda: [ad.adapter_content_torch(
                    d[0], d[2], n, adapter_host=a)
                    for a in FASTQC_ADAPTERS], inner=1),
                launch_floor_ms=floor,
                **adapter_bound(d[0], d[2], n, FASTQC_ADAPTERS))
        # read_hashes: `ms` is a call into a sample buffer, as run_parser
        # makes it; under `variants` the call that returns a new tensor,
        # and the wide shape
        sample = torch.empty((2 * n, 2), dtype=torch.int64, device="cuda")
        hrec = dict(
            shape=[n, L], ms=cuda_ms(lambda: dedup._read_hashes_into(
                d[0], d[2], n, sample, n, n)),
            new_tensor_ms=cuda_ms(lambda: dedup.read_hashes(d[0], d[2], n)),
            plain_ms=cuda_ms(lambda: dedup.read_hashes_torch(
                d[0], d[2], n), inner=2),
            launch_floor_ms=floor, **hash_bound(lengths, L, n, n))
        if (n, L) == PANEL_SHAPE:
            recs["read_hashes"] = dict(hrec, variants={})
        else:
            recs["read_hashes"]["variants"]["%dx%d" % (n, L)] = hrec
        del d, batches, sample
    for L in PANEL_EDGE_WIDTHS:
        batches = []
        for offset in (33, 64):
            seq, qual, lengths, codes = panel_inputs(rng, 300, L, offset)
            lengths[:4] = (0, L, L + 1, 2 * L + 1)
            dlen, dcodes = (torch.from_numpy(a).cuda()
                            for a in (lengths, codes))
            # negative lengths: the hashes mix them in, unclipped
            neg = lengths.copy()
            neg[4:6] = (-1, -L - 7)
            for off in (0, 1):
                b = (_card_rows(seq, off), _card_rows(qual, off), dlen,
                     dcodes, offset)
                compare_all(*b, "L=%d offset %d off %d" % (L, offset, off))
                batches.append(b)
                for nr in (300, 151, 0):
                    compare_hashes(b[0], torch.from_numpy(neg).cuda(), nr,
                                   "L=%d off %d negative lengths" % (L, off))
        compare_totals(batches[1:], "L=%d" % L)
    n, L = PANEL_TALL
    d = [torch.from_numpy(a).cuda() for a in panel_inputs(rng, n, L)]
    compare_all(*d, 33, "[%d, %d]" % (n, L))
    del d
    recs["qc_stats"]["variants"] = variants
    recs["adapter_content"]["variants"] = ad_variants
    for name, rec in recs.items():
        rec["max_abs_err"] = 0
        log("%s %s: kernel %.4f ms, plain %.4f ms, bound %.5f ms (%s)"
            % (name, rec["shape"], rec["ms"], rec["plain_ms"],
               rec["bound_ms"], rec["bound_by"]))
    for tag, rec in (list(variants.items()) + list(ad_variants.items())
                     + list(recs["read_hashes"]["variants"].items())):
        log("%s %s: kernel %.4f ms, plain %.4f ms, bound %.5f ms (%s)"
            % ("adapter_content" if tag.startswith("adapters") else
               "read_hashes" if tag in recs["read_hashes"]["variants"] else
               "qc_stats", tag, rec["ms"], rec["plain_ms"], rec["bound_ms"],
               rec["bound_by"]))
    for tag, rec in [("%dx%d" % PANEL_SHAPE, recs["read_hashes"]),
                     *recs["read_hashes"]["variants"].items()]:
        log("read_hashes %s: into a sample %.4f ms a call, into a new "
            "tensor %.4f ms" % (tag, rec["ms"], rec["new_tensor_ms"]))
    log("padded-batch panel kernels == plain on %d cases" % n_cases)
    return recs


def _records(n, read_len, schema, rng, header_width=12):
    """u8[n, rs] uniform records of one read length under `schema`."""
    recs = []
    for i in range(n):
        q = rng.integers(schema.LOWER, schema.UPPER + 1, read_len)
        s = _SEQ_LUT[rng.integers(0, 256, read_len)]
        recs.append(b"@" + (b"r%d" % i).ljust(header_width - 1, b"x")
                    + b"\n" + s.tobytes() + b"\n+\n"
                    + q.astype(np.uint8).tobytes() + b"\n")
    return np.frombuffer(b"".join(recs), np.uint8).reshape(n, -1).copy()


def phase_kernel_b(seed):
    """Kernel B (uniform QC) against its plain version on the card."""
    import torch

    from blazeseq_tpu_torch import parse_schema
    from blazeseq_tpu_torch.ops.uniform_parse import detect_uniform_layout
    from blazeseq_tpu_torch.ops.uniform_qc import (_uniform_qc_raw_cuda,
                                                   _uniform_qc_raw_torch,
                                                   uniform_qc,
                                                   uniform_qc_torch)

    rng = np.random.default_rng([seed, 2])
    err = 0
    n_cases = 0

    def compare(arr, n_valid, lay, width, schema, label, **kw):
        nonlocal err, n_cases
        args = dict(rs=lay.rs, o1=lay.o1, o2=lay.o2, o3=lay.o3, width=width,
                    q_lo=int(schema.LOWER), q_hi=int(schema.UPPER),
                    offset=int(schema.OFFSET), **kw)
        c = torch.from_numpy(arr).cuda()
        ok_k, st_k = uniform_qc(c, n_valid, **args)
        ok_t, st_t = uniform_qc_torch(c, n_valid, **args)
        torch.cuda.synchronize()
        err = max(err, max_abs_diff((ok_k, *st_k), (ok_t, *st_t),
                                    "kernel B, " + label))
        n_cases += 1
        return bool(ok_k)

    sanger = parse_schema("sanger")
    for read_len in (25, 100, 151, 250):
        for sname in ("sanger", "illumina_1.3"):
            schema = parse_schema(sname)
            arr = _records(600, read_len, schema, rng)
            lay = detect_uniform_layout(arr)
            pad = np.concatenate([arr, np.zeros((7, lay.rs), np.uint8)])
            for width in (128, 256):
                for cq in (True, False):
                    if not compare(pad, arr.size, lay, width, schema,
                                   "L=%d %s w=%d q=%s" % (
                                       read_len, sname, width, cq),
                                   check_quality=cq):
                        raise AssertionError("clean corpus rejected")
    arr = _records(300, 100, sanger, rng)
    lay = detect_uniform_layout(arr)
    mutations = dict(newline=(lay.o1, ord("x")), at=(0, ord("#")),
                     plus=(lay.o2 + 1, ord("-")),
                     ascii=(lay.o1 + 2, 0x80 | ord("A")),
                     quality=(lay.o3 + 2, 1))
    for kind, (col, val) in mutations.items():
        bad = arr.copy()
        bad[117, col] = val
        if compare(bad, bad.size, lay, 128, sanger, "violation " + kind):
            raise AssertionError("violation %s accepted" % kind)
    beyond = arr.copy()
    beyond[250, 0] = ord("#")
    if not compare(beyond, 200 * lay.rs, lay, 128, sanger,
                   "violation beyond n_valid"):
        raise AssertionError("violation beyond n_valid rejected")
    binned = arr.copy()
    q = binned[:, lay.o3 + 1:lay.rs - 1].astype(np.int64) - 33
    binned[:, lay.o3 + 1:lay.rs - 1] = _PHRED_LUT[np.minimum(q, 63)] + 33
    compare(binned, binned.size, lay, 128, sanger, "eq-mode",
            hist_vals=(2, 12, 23, 37))
    binned[3, lay.o3 + 1] = 33 + 9  # a value outside the set
    compare(binned, binned.size, lay, 128, sanger, "eq-mode remainder",
            hist_vals=(2, 12, 23, 37))
    # the kernel's tiles: odd and even record sizes, nrec_valid ending
    # inside a tile, a violation in a tile's first and last row and in the
    # rows past the last whole tile, binned eq-mode with a value outside
    # the set
    from blazeseq_tpu_torch import _kernels

    for header_width in (12, 13):
        arr = _records(3000, 150, sanger, rng, header_width)
        lay = detect_uniform_layout(arr)
        R = _kernels.load().bs_uniform_qc_tile_rows(lay.rs)
        n_valid = (3000 // R - 1) * R + R // 2 + 1
        arr[n_valid + 1, 0] = ord("#")  # past nrec_valid: ignored
        q = arr[:, lay.o3 + 1:lay.rs - 1].astype(np.int64) - 33
        eq = arr.copy()
        eq[:, lay.o3 + 1:lay.rs - 1] = _PHRED_LUT[np.minimum(q, 63)] + 33
        eq[n_valid - 2, lay.o3 + 1] = 33 + 9
        for width in (128, 256):
            tag = "rs=%d w=%d" % (lay.rs, width)
            if not compare(arr, n_valid * lay.rs, lay, width, sanger,
                           tag + " mid-tile end"):
                raise AssertionError("clean tiles rejected, " + tag)
            compare(eq, n_valid * lay.rs, lay, width, sanger,
                    tag + " eq-mode remainder", hist_vals=(2, 12, 23, 37))
            for kind, (row, col, val) in dict(
                    first_row=(2 * R, lay.o2 + 1, ord("-")),
                    last_row=(3 * R - 1, lay.o3 + 2, 0x80 | 40),
                    tail_row=(n_valid - 1, lay.o1, ord("x"))).items():
                bad = arr.copy()
                bad[row, col] = val
                if compare(bad, n_valid * lay.rs, lay, width, sanger,
                           "%s violation in the %s" % (tag, kind)):
                    raise AssertionError("violation in the %s accepted, %s"
                                         % (kind, tag))

    # time one full-size chunk of the main path's layout
    n = (256 << 20) // RS
    rec, _ = _make_block(seed, 10 ** 6, 0, n, False)
    lay = detect_uniform_layout(rec)
    c = torch.from_numpy(rec).cuda()
    args = dict(rs=lay.rs, o1=lay.o1, o2=lay.o2, o3=lay.o3, width=256,
                q_lo=int(sanger.LOWER), q_hi=int(sanger.UPPER),
                offset=int(sanger.OFFSET))
    compare(rec, rec.size, lay, 256, sanger, "256 MiB chunk")
    # the kernel's own launch against its plain twin, without the torch
    # epilogue that folds the raw sums into QCStats (its small launches
    # would time the host)
    cnt = min(READ_LEN, 256)
    raw = dict(rs=lay.rs, o1=lay.o1, o2=lay.o2, o3=lay.o3, cnt=cnt,
               q_lo=args["q_lo"], q_hi=args["q_hi"], offset=args["offset"],
               check_ascii=True, check_quality=True)
    ms = cuda_ms(lambda: _uniform_qc_raw_cuda(c, n, **raw), inner=3)
    plain_ms = cuda_ms(lambda: _uniform_qc_raw_torch(c, n, **raw), inner=2)
    # reads the chunk once, writes 1 + 5 cnt + 64 + 101 + 64 int32 sums;
    # at least one op per window byte (two per position) and one per
    # 4-byte word of the proof
    bnd = bound(rec.size + 4 * (1 + 5 * cnt + 64 + 101 + 64),
                n * (2 * cnt + -(-lay.rs // 4)))
    log("kernel B == plain on %d cases; 256 MiB chunk (%d x %d): kernel "
        "%.3f ms (%.1f GB/s), plain %.3f ms, bound %.4f ms (%s)" % (
            n_cases, n, RS, ms, rec.size / ms / 1e6, plain_ms,
            bnd["bound_ms"], bnd["bound_by"]))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **bnd)


def _run_main(path, oracle, size, binned):
    import torch

    from blazeseq_tpu_torch import QCModel
    from blazeseq_tpu_torch.ops.uniform_qc import uniform_qc
    from blazeseq_tpu_torch.ops.validate import validate_decode

    model = QCModel(quality_schema="sanger", device="cuda")
    before = (uniform_qc.launches, validate_decode.launches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = model.run_file_device(path)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = (uniform_qc.launches - before[0],
                validate_decode.launches - before[1])
    check_report(rep, oracle, model.max_read_len)
    csize = (256 << 20) // RS * RS
    chunks = -(-size // csize)
    log("%s: %d bytes, %d reads, %d bases: %.3f s wall, %.3f GB/s; "
        "tier_chunks %s; launches uniform_qc %d, validate_decode %d; "
        "eq-mode sets %s" % (
            "binned" if binned else "main", size, rep.reads, rep.bases, wall,
            size / wall / 1e9, model.tier_chunks, launched[0], launched[1],
            sorted(model._hist_his)))
    if model.tier_chunks != dict(uniform=chunks, semi=0, ragged=0, host=0):
        raise AssertionError("expected %d uniform chunks and no other "
                             "route, got %s" % (chunks, model.tier_chunks))
    if launched[0] < model.tier_chunks["uniform"]:
        raise AssertionError("uniform_qc launched %d times for %d chunks"
                             % (launched[0], chunks))
    if binned and model._hist_his != {tuple(int(v) for v in NOVASEQ_BINS)}:
        raise AssertionError("eq-mode did not engage, or the file re-ran: "
                             "%r" % (model._hist_his,))
    return dict(bytes=size, wall_s=wall, gbps=size / wall / 1e9)


def phase_main_path(seed, tmp):
    """2 GiB uniform FASTQ, then a 1 GiB binned one, through
    QCModel.run_file_device on the card, against the numpy oracle."""
    need = (3 << 30) + (256 << 20)
    free = shutil.disk_usage(tmp).free
    if free < need:
        raise RuntimeError("run_file_device needs %d free bytes in %s, "
                           "found %d"
                           % (need, tmp, free))
    out = {}
    for label, gib, binned in (("main", 2, False), ("binned", 1, True)):
        path = os.path.join(tmp, label + ".fastq")
        n = (gib << 30) // RS
        t0 = time.perf_counter()
        oracle = write_corpus(path, n, seed + (7 if binned else 0), binned)
        log("%s corpus: %d records of %d bytes written in %.1f s"
            % (label, n, RS, time.perf_counter() - t0))
        try:
            out[label] = _run_main(path, oracle, n * RS, binned)
        finally:
            os.unlink(path)
    return out


def phase_fallback(seed, tmp):
    """The host route on the card (a mid-file quality error and a trailing
    partial record) against the same call on the CPU."""
    import torch

    from blazeseq_tpu_torch import QCModel
    from blazeseq_tpu_torch.ops.validate import validate_decode

    path = os.path.join(tmp, "fallback.fastq")
    n = (64 << 20) // RS
    write_corpus(path, n, seed + 13)
    with open(path, "r+b") as f:
        f.seek((n // 2) * RS + len(HEADER) + READ_LEN + 4 + 17)
        f.write(b"\x20")  # below the sanger range: one error read
        f.truncate(n * RS - 1)  # the last record loses its final newline
    try:
        before = validate_decode.launches
        gpu = QCModel(quality_schema="sanger", device="cuda")
        rep_gpu = gpu.run_file_device(path, chunk_mb=8)
        torch.cuda.synchronize()
        rep_cpu = QCModel(quality_schema="sanger",
                          device="cpu").run_file_device(path, chunk_mb=8)
    finally:
        os.unlink(path)
    for k, v in vars(rep_cpu).items():
        if not np.array_equal(np.asarray(getattr(rep_gpu, k)), np.asarray(v)):
            raise AssertionError("fallback: %s differs between cuda and "
                                 "cpu" % k)
    if rep_gpu.error_reads != 1 or rep_gpu.reads != n:
        raise AssertionError("fallback: %d reads, %d error reads"
                             % (rep_gpu.reads, rep_gpu.error_reads))
    if validate_decode.launches <= before:
        raise AssertionError("fallback never launched kernel A")
    log("fallback: cuda == cpu; %d reads, %d error reads; tier_chunks %s"
        % (rep_gpu.reads, rep_gpu.error_reads, gpu.tier_chunks))


def phase_kernel_nw(seed):
    """The NW kernel against its plain version on the card, exact, at the
    upstream example's shape, QCModel's batch and width, and edge batches
    (lengths 0, 1 and = width, bytes 0xFE and 0xFF, references of 1, 31,
    32, 33, 160, 1,000 and 2,100 bytes (three column tiles), a width that
    is not a multiple of 16 and batches that are not a multiple of the
    reads per block). Returns the
    JSON fields (timed at the example's shape) and the timings and bounds
    of both timed shapes."""
    import torch

    from blazeseq_tpu_torch.ops.nw import (needleman_wunsch_cpu, nw_scores,
                                           nw_scores_torch)

    rng = np.random.default_rng([seed, 3])
    acgt = np.frombuffer(b"ACGT", np.uint8)
    edge = np.frombuffer(b"ACGT\xfe\xff", np.uint8)
    cases = [("example", NW_BATCH, 64, len(NW_REFERENCE), NW_READ_LEN, acgt),
             ("qc_batch", 4096, 256, READ_LEN, READ_LEN, acgt),
             ("edge_ref_1", 4096, 128, 1, None, edge),
             ("edge_ref_1000", 4096, 128, 1000, None, edge)]
    cases += [("edge_ref_%d" % lr, 4099, 100, lr, None, edge)
              for lr in (31, 32, 33, 160, 2100)]
    err = 0
    times = {}
    for label, B, Lq, Lr, read_len, alpha in cases:
        seq = rng.choice(alpha, (B, Lq))
        ref = rng.choice(alpha, Lr)
        lengths = (rng.integers(0, Lq + 1, B) if read_len is None
                   else np.full(B, read_len)).astype(np.int32)
        lengths[:8] = 0
        lengths[8:16] = Lq
        lengths[17:24] = 1
        d = [torch.from_numpy(a).cuda() for a in (seq, lengths, ref)]
        got = nw_scores(*d)
        want = nw_scores_torch(*d)
        torch.cuda.synchronize()
        err = max(err, max_abs_diff((got,), (want,), "NW kernel, " + label))
        host = got.cpu().numpy()
        for b in (0, 8, 16, 17, B - 1):
            twin = needleman_wunsch_cpu(seq[b, :lengths[b]].tobytes(),
                                        ref.tobytes())
            if host[b] != twin:
                raise AssertionError("NW kernel, %s: row %d scores %d, the "
                                     "numpy twin %d" % (label, b, host[b],
                                                        twin))
        if label in ("example", "qc_batch"):
            ms = cuda_ms(lambda: nw_scores(*d))
            plain_ms = cuda_ms(lambda: nw_scores_torch(*d), inner=1,
                               trials=3)
            # the DP cells this batch needs: each read's own length
            cells = int(np.clip(lengths, 0, Lq).astype(np.int64).sum()) * Lr
            bnd = bound(nbytes(*d, got), NW_OPS_PER_CELL * cells)
            times[label] = dict(B=B, Lq=Lq, Lr=Lr, ms=ms, plain_ms=plain_ms,
                                cells=cells, **bnd)
            log("NW kernel [%d, %d] vs Lr=%d: kernel %.4f ms, plain %.3f ms, "
                "bound %.4f ms (%s, %d cells)" % (
                    B, Lq, Lr, ms, plain_ms, bnd["bound_ms"],
                    bnd["bound_by"], cells))
    log("NW kernel == plain on %d shapes" % len(cases))
    ex = times["example"]
    return dict(max_abs_err=err, ms=ex["ms"], plain_ms=ex["plain_ms"],
                bound_ms=ex["bound_ms"], bound_by=ex["bound_by"]), times


_NW_CORPUS = []


def nw_corpus():
    """The aligner paths' 1M x 40 bp FASTQ bytes, made at first use."""
    import blazeseq_tpu_torch as bt

    if not _NW_CORPUS:
        t0 = time.perf_counter()
        _NW_CORPUS.append(bytes(bt.generate_synthetic_fastq_buffer(
            NW_READS, NW_READ_LEN, NW_READ_LEN, 2, 40, "sanger")))
        log("aligner corpus: %d reads x %d bp (%d bytes) made in %.1f s"
            % (NW_READS, NW_READ_LEN, len(_NW_CORPUS[0]),
               time.perf_counter() - t0))
    return _NW_CORPUS[0]


def _variant_cells(mode, lengths, Lq, Lr):
    """The DP cells a variant mode's batch needs: each read's rows (the
    local modes take min(len, Lq) rows; the others a length in [1, Lq],
    and none for the lengths they score without a DP) times Lr."""
    L = lengths.astype(np.int64)
    if mode.startswith("local"):
        rows = np.clip(L, 0, Lq)
    else:
        rows = np.where((L >= 1) & (L <= Lq), L, 0)
    return int(rows.sum()) * Lr


def _variant_twin(mode, q, r, sc):
    """The numpy twin of a variant mode's score of q against r."""
    from blazeseq_tpu_torch.ops import nw

    twin = dict(local=nw.smith_waterman_cpu, semiglobal=nw.semiglobal_cpu,
                affine=nw.needleman_wunsch_affine_cpu,
                local_affine=nw.smith_waterman_affine_cpu,
                semiglobal_affine=nw.semiglobal_affine_cpu)[mode]
    kw = (dict(gap_open=sc["gap_open"], gap_extend=sc["gap_extend"])
          if "affine" in mode else dict(gap=sc["gap"]))
    return twin(q, r, match=sc["match"], mismatch=sc["mismatch"], **kw)


def phase_kernel_nw_variants(seed):
    """The alignment variant kernel against its plain torch versions on the
    card, exact on every row, in each of its five modes: at the upstream
    example's shape (65,536 x 64 vs 40 bp) and the QC batch (4,096 x 256
    vs 150 bp), timed, with rows of each against the numpy twins; and on
    edge batches of 1,003 rows: references of 1, 31, 32, 33, 1,000 and
    2,100 bytes (one tile or several; 2, 4 and 32 lanes a read), rows of
    64 and 100 bytes, lengths 0, 1, Lq and out of range, bytes 0xFE and
    0xFF; each shape with both score sets of NW_VARIANT_SCORES. Returns
    the kernels-line fields (ms, plain_ms and the bound of the five modes'
    calls together at the example's shape) and each mode's timings."""
    import torch

    from blazeseq_tpu_torch.ops import nw

    t0 = time.perf_counter()
    rng = np.random.default_rng([seed, 11])
    acgt = np.frombuffer(b"ACGT", np.uint8)
    edge = np.frombuffer(b"ACGT\xfe\xff", np.uint8)
    cases = [("example", NW_BATCH, 64, len(NW_REFERENCE), NW_READ_LEN, acgt),
             ("qc_batch", 4096, 256, READ_LEN, READ_LEN, acgt)]
    cases += [("edge_ref_%d_w%d" % (lr, lq), 1003, lq, lr, None, edge)
              for lr in (1, 31, 32, 33, 1000, 2100) for lq in (64, 100)]
    err = 0
    modes = {m: {} for m in nw.VARIANT_MODES}
    totals = dict(ms=0.0, plain_ms=0.0, bytes=0, ops=0)
    for label, B, Lq, Lr, read_len, alpha in cases:
        seq = rng.choice(alpha, (B, Lq))
        ref = rng.choice(alpha, Lr)
        lengths = (rng.integers(0, Lq + 1, B) if read_len is None
                   else np.full(B, read_len)).astype(np.int32)
        lengths[:8] = 0
        lengths[8:16] = Lq
        lengths[17:24] = 1
        if read_len is None:
            lengths[24:28] = (-1, Lq + 1, -Lr - 1, Lq + Lr + 1)
        d = [torch.from_numpy(a).cuda() for a in (seq, lengths, ref)]
        for mode, (_, plain, affine) in nw.VARIANT_MODES.items():
            for k, sc in enumerate(NW_VARIANT_SCORES):
                kw = dict(match=sc["match"], mismatch=sc["mismatch"])
                kw.update(dict(gap_open=sc["gap_open"],
                               gap_extend=sc["gap_extend"]) if affine
                          else dict(gap=sc["gap"]))
                got = nw.nw_variant_scores(*d, mode, **sc)
                want = getattr(nw, plain)(*d, **kw)
                torch.cuda.synchronize()
                err = max(err, max_abs_diff(
                    (got,), (want,), "variant kernel, %s, %s, scores %d"
                    % (mode, label, k)))
                if read_len is None:
                    continue
                host = got.cpu().numpy()
                for b in (0, 8, 17, B - 1):
                    twin = _variant_twin(mode, seq[b, :lengths[b]].tobytes(),
                                         ref.tobytes(), sc)
                    if host[b] != twin:
                        raise AssertionError(
                            "variant kernel, %s, %s: row %d scores %d, the "
                            "numpy twin %d" % (mode, label, b, host[b],
                                               twin))
            if read_len is None:
                continue
            ms = cuda_ms(lambda: nw.nw_variant_scores(*d, mode))
            plain_ms = cuda_ms(lambda: getattr(nw, plain)(*d), inner=1,
                               trials=3)
            cells = _variant_cells(mode, lengths, Lq, Lr)
            ops = NW_VARIANT_OPS_PER_CELL[mode] * cells
            n_bytes = nbytes(*d, got)
            bnd = bound(n_bytes, ops)
            modes[mode][label] = dict(B=B, Lq=Lq, Lr=Lr, ms=ms,
                                      plain_ms=plain_ms, cells=cells,
                                      share=bnd["bound_ms"] / ms, **bnd)
            if label == "example":
                totals["ms"] += ms
                totals["plain_ms"] += plain_ms
                totals["bytes"] += n_bytes
                totals["ops"] += ops
            log("variant kernel %s [%d, %d] vs Lr=%d: kernel %.4f ms, plain "
                "%.3f ms, bound %.4f ms (%s, %d cells), %.1f%% of it" % (
                    mode, B, Lq, Lr, ms, plain_ms, bnd["bound_ms"],
                    bnd["bound_by"], cells, 100 * bnd["bound_ms"] / ms))
    log("variant kernel == plain in %d modes on %d shapes, %d score sets "
        "(%.1f s)" % (len(modes), len(cases), len(NW_VARIANT_SCORES),
                      time.perf_counter() - t0))
    # the five modes' calls at the example's shape, as one unit of work
    bnd = bound(totals["bytes"], totals["ops"])
    return dict(max_abs_err=err, ms=totals["ms"],
                plain_ms=totals["plain_ms"], **bnd), modes


def _twin_chunk(head, n, mode, gap_open):
    """NWAligner.score_cpu (the numpy twins) in one mode on the n records
    of the FASTQ bytes `head`; runs in a process of its own."""
    import blazeseq_tpu_torch as bt
    from blazeseq_tpu_torch import NWAligner

    batch = bt.FastqParser(bt.MemoryReader(head)).next_batch(n)
    return NWAligner(NW_REFERENCE, max_query_len=64, mode=mode,
                     gap_open=gap_open, device="cpu").score_cpu(batch)


def phase_aligner_variants():
    """NWAligner in its five variant combinations (local, semi-global, and
    global, local and semi-global with affine gaps, gap_open -3) at the
    upstream example's scale, as the NWAligner path: host parse into
    padded batches of 65,536, scores on the card (the variant kernel),
    alignments/s of each; then the first TWIN_SAMPLE scores of each
    against score_cpu, computed in parallel processes (the affine twins
    are Python loops over every cell)."""
    import multiprocessing

    import torch

    import blazeseq_tpu_torch as bt
    from blazeseq_tpu_torch import NWAligner

    buf = nw_corpus()
    out, scores = {}, {}
    for label, (mode, gap_open) in NW_VARIANTS.items():
        aligner = NWAligner(NW_REFERENCE, max_query_len=64, mode=mode,
                            gap_open=gap_open, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        parts = [aligner.score_padded(pb)
                 for pb in bt.FastqParser(bt.MemoryReader(buf))
                 .padded_batches(NW_BATCH, max_len=64,
                                 pad_records_to=NW_BATCH)]
        wall = time.perf_counter() - t0
        got = np.concatenate(parts)
        if got.shape != (NW_READS,) or got.dtype != np.int32:
            raise AssertionError("aligner %s: %s scores of %s"
                                 % (label, got.shape, got.dtype))
        scores[label] = got
        out[label] = dict(wall_s=wall, alignments_per_s=NW_READS / wall)
        log("aligner %s (mode %s, gap_open %s): %d alignments in %.3f s, "
            "%.0f alignments/s" % (label, mode, gap_open, NW_READS, wall,
                                   NW_READS / wall))
    # the first TWIN_SAMPLE records in four runs of whole records
    t0 = time.perf_counter()
    head = np.frombuffer(buf, np.uint8,
                         min(len(buf), TWIN_SAMPLE * (2 * NW_READ_LEN + 200)))
    nl = np.flatnonzero(head == 10)
    step = TWIN_SAMPLE // 4
    ends = [0] + [int(nl[4 * k - 1]) + 1
                  for k in range(step, TWIN_SAMPLE + 1, step)]
    ctx = multiprocessing.get_context("spawn")
    with cf.ProcessPoolExecutor(max(1, min(7, os.cpu_count() or 1)),
                                mp_context=ctx) as ex:
        jobs = {label: [ex.submit(_twin_chunk, buf[lo:hi], step, mode, go)
                        for lo, hi in zip(ends, ends[1:])]
                for label, (mode, go) in NW_VARIANTS.items()}
        for label, futs in jobs.items():
            twin = np.concatenate([f.result() for f in futs])
            if not np.array_equal(scores[label][:TWIN_SAMPLE], twin):
                raise AssertionError("aligner %s: scores differ from the "
                                     "numpy twin" % label)
    log("aligner variants: the first %d scores of each of the %d == numpy "
        "twin (%.1f s)" % (TWIN_SAMPLE, len(NW_VARIANTS),
                           time.perf_counter() - t0))
    return dict(reads=NW_READS, modes=out)


def phase_aligner():
    """NWAligner end to end at the upstream nw_gpu example's scale: host
    parse into padded batches of 65,536, scores on the card, the first
    2,000 against the numpy twin."""
    import torch

    import blazeseq_tpu_torch as bt
    from blazeseq_tpu_torch import NWAligner

    buf = nw_corpus()
    aligner = NWAligner(NW_REFERENCE, max_query_len=64, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    parts = [aligner.score_padded(pb)
             for pb in bt.FastqParser(bt.MemoryReader(buf)).padded_batches(
                 NW_BATCH, max_len=64, pad_records_to=NW_BATCH)]
    wall = time.perf_counter() - t0
    scores = np.concatenate(parts)
    if scores.shape != (NW_READS,) or scores.dtype != np.int32:
        raise AssertionError("aligner: %s scores of %s"
                             % (scores.shape, scores.dtype))
    batch = bt.FastqParser(bt.MemoryReader(buf)).next_batch(TWIN_SAMPLE)
    if not np.array_equal(scores[:TWIN_SAMPLE], aligner.score_cpu(batch)):
        raise AssertionError("aligner: scores differ from the numpy twin")
    rate = NW_READS / wall
    log("aligner: %d alignments in %.3f s, %.0f alignments/s; first %d == "
        "numpy twin" % (NW_READS, wall, rate, TWIN_SAMPLE))
    return dict(reads=NW_READS, wall_s=wall, alignments_per_s=rate)


def _same_reports(a, b, label):
    """Every panel of two QCReports equal; raises on the first that is
    not."""
    da, db = a.to_dict(), b.to_dict()
    if da != db:
        raise AssertionError("%s: to_dict differs in %s" % (label, sorted(
            k for k in set(da) | set(db) if da.get(k) != db.get(k))))
    for k in ("nw_scores", "duplication_levels", "quality_quartiles",
              "per_pos_qual_hist", "base_counts", "qual_hist",
              "per_pos_base_counts"):
        x, y = getattr(a, k), getattr(b, k)
        if (x is None) != (y is None) or (
                x is not None and not np.array_equal(x, y)):
            raise AssertionError("%s: %s differs" % (label, k))
    for ad, st in (a.adapter_stats or {}).items():
        if not all(np.array_equal(x, y)
                   for x, y in zip(st, b.adapter_stats[ad])):
            raise AssertionError("%s: adapter panel %r differs" % (label, ad))
    if a.overrepresented != b.overrepresented:
        raise AssertionError("%s: overrepresented sequences differ" % label)


def make_align_corpus(seed, tmp):
    """The planted 1M x 150 bp corpus, its 20,000-read prefix, and the
    merge mates (MATE_PAIRS pairs and a 20,000-pair prefix), written once
    for the run_file(align_to) and cli paths."""
    t0 = time.perf_counter()
    files = dict(align=os.path.join(tmp, "align.fastq"),
                 align_prefix=os.path.join(tmp, "align_prefix.fastq"),
                 r1=os.path.join(tmp, "r1.fastq"),
                 r2=os.path.join(tmp, "r2.fastq"))
    oracle = write_corpus(files["align"], ALIGN_READS, seed + 17,
                          planted=True)
    mate_rs = write_mates(files["r1"], files["r2"], MATE_PAIRS, seed)
    for name, rs in (("align", RS), ("r1", mate_rs), ("r2", mate_rs)):
        with open(files[name], "rb") as f:
            head = f.read(ALIGN_PREFIX_READS * rs)
        files[name + "_prefix"] = os.path.join(tmp, name + "_prefix.fastq")
        with open(files[name + "_prefix"], "wb") as f:
            f.write(head)
    log("align corpus: %d records of %d bytes, %d mate pairs of %d bytes, "
        "written in %.1f s" % (ALIGN_READS, RS, MATE_PAIRS, mate_rs,
                               time.perf_counter() - t0))
    return files, oracle


def _align_kw(seed):
    """QCModel's options on the run_file(align_to) path: a 150 bp
    reference drawn from the seed, the adapter, duplicates, quartiles."""
    ref = np.random.default_rng([seed, 4]).choice(
        np.frombuffer(b"ACGT", np.uint8), READ_LEN).tobytes()
    return dict(quality_schema="sanger", align_to=ref, adapters=[ADAPTER],
                track_duplicates=True, track_quartiles=True)


def dup_oracle(path, n_sample):
    """The duplication panel of the first `n_sample` uniform records of
    `path` in numpy alone: both wrapping uint32 hashes of each read (its
    READ_LEN bases, the length mixed in) as uint64 products masked to 32
    bits, then (levels, frac_unique, {prefix: count} of the reads above
    0.1% of the sample)."""
    m32 = np.uint64(0xFFFFFFFF)
    recs = np.fromfile(path, np.uint8, n_sample * RS).reshape(-1, RS)
    seq = recs[:, len(HEADER) + 1:len(HEADER) + 1 + READ_LEN]
    keys = np.zeros(len(seq), np.uint64)
    for base, salt, shift in ((1000003, 2654435761, 32),
                              (0x01000193, 0x9E3779B1, 0)):
        p = np.ones(READ_LEN, np.uint64)
        for j in range(1, READ_LEN):
            p[j] = (int(p[j - 1]) * base) & 0xFFFFFFFF
        h = ((seq.astype(np.uint64) * p) & m32).sum(1, dtype=np.uint64)
        h = (h + np.uint64(READ_LEN * salt)) & m32
        keys |= h << np.uint64(shift)
    _, first, counts = np.unique(keys, return_index=True, return_counts=True)
    levels = np.bincount(np.minimum(counts, 10), minlength=11)
    hot = (counts > 1) & (counts / len(keys) > 0.001)
    prefixes = {seq[i, :50].tobytes(): int(c)
                for i, c in zip(first[hot], counts[hot])}
    return levels, float((counts == 1).sum()) / len(keys), prefixes


def check_dup_panel(rep, path, n_sample, label):
    """rep's duplication panel against dup_oracle: levels and the unique
    fraction equal; the overrepresented list the oracle's most frequent
    reads (at most 20, most frequent first, ties in any order)."""
    levels, frac, hot = dup_oracle(path, n_sample)
    if not np.array_equal(np.asarray(rep.duplication_levels), levels):
        raise AssertionError("%s: duplication levels %s, oracle %s" % (
            label, list(rep.duplication_levels), list(levels)))
    if rep.frac_unique_reads != frac:
        raise AssertionError("%s: unique fraction %r, oracle %r"
                             % (label, rep.frac_unique_reads, frac))
    got = rep.overrepresented
    counts = sorted(hot.values(), reverse=True)[:20]
    if ([c for _, c in got] != counts
            or any(hot.get(p) != c for p, c in got)):
        raise AssertionError("%s: overrepresented %s, oracle's top %s"
                             % (label, got[:3], counts[:3]))
    return len(hot)


def phase_align_run_file(seed, files, oracle, keep):
    """QCModel(align_to=..., adapters, duplicates, quartiles).run_file on
    1M reads x 150 bp on the card: core panels against the oracle, the
    duplication panel of the default 200,000-read sample against
    dup_oracle, 2,000 alignment scores against the numpy twin, and every
    panel of a
    20,000-read prefix against the same call on the CPU. The report and
    its wall time go into `keep` for the mesh path."""
    import torch

    import blazeseq_tpu_torch as bt
    from blazeseq_tpu_torch import QCModel
    from blazeseq_tpu_torch.ops.nw import needleman_wunsch_cpu

    kw = _align_kw(seed)
    ref = kw["align_to"]
    path, prefix = files["align"], files["align_prefix"]
    with open(prefix, "rb") as f:
        head = f.read()
    model = QCModel(device="cuda", **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = model.run_file(path)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_report(rep, oracle, model.max_read_len)
    keep.update(align_report=rep, align_wall_s=wall)
    if rep.nw_scores.shape != (ALIGN_READS,):
        raise AssertionError("run_file: %s alignment scores"
                             % (rep.nw_scores.shape,))
    batch = bt.FastqParser(bt.MemoryReader(head)).next_batch(TWIN_SAMPLE)
    twin = np.array([needleman_wunsch_cpu(
        batch.get_ref(i).sequence_bytes(), ref)
        for i in range(TWIN_SAMPLE)], np.int32)
    if not np.array_equal(rep.nw_scores[:TWIN_SAMPLE], twin):
        raise AssertionError("run_file: alignment scores differ from "
                             "the numpy twin")
    hits = int(rep.adapter_stats[ADAPTER].reads_with_adapter)
    if hits < ALIGN_READS // 8:
        raise AssertionError("run_file: %d reads with the adapter, "
                             "%d planted" % (hits, ALIGN_READS // 8))
    if rep.frac_unique_reads >= 1.0:
        raise AssertionError("run_file: no duplicate found")
    sample = min(model.dup_track_limit, ALIGN_READS)
    n_hot = check_dup_panel(rep, path, sample, "run_file")
    size = ALIGN_READS * RS
    log("run_file(align_to, adapters, duplicates, quartiles): %d reads "
        "in %.3f s, %.0f reads/s, %.3f GB/s; adapter in %d reads, "
        "unique %.4f; duplication panel of the first %d reads == numpy "
        "oracle (%d overrepresented); first %d scores == numpy twin"
        % (ALIGN_READS, wall, ALIGN_READS / wall, size / wall / 1e9,
           hits, rep.frac_unique_reads, sample, n_hot, TWIN_SAMPLE))
    gpu = QCModel(device="cuda", **kw).run_file(prefix)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cpu = QCModel(device="cpu", **kw).run_file(prefix)
    _same_reports(gpu, cpu, "run_file prefix, cuda vs cpu")
    log("run_file prefix (%d reads): cuda == cpu on every panel (cpu "
        "took %.1f s)" % (ALIGN_PREFIX_READS, time.perf_counter() - t0))
    return dict(reads=ALIGN_READS, bytes=size, wall_s=wall,
                reads_per_s=ALIGN_READS / wall, gbps=size / wall / 1e9)


def phase_kernel_scan(seed):
    """The structural-bitmap kernel against its plain version on the card,
    bit-exact on all four outputs: a 256 MiB chunk of the smoke's records,
    64 MiB of bytes drawn from {'\\n', '@', '+', 'A'}, every byte value
    beside each class byte, views of the records at 1, 5 and 16 bytes into
    their storage (the kernel's unaligned branch), and
    count_records_device at N = 1, 127, 129 and 128k + 5 (zero padding)
    and on an unaligned view. Both timed on the 256 MiB chunk."""
    import torch

    from blazeseq_tpu_torch.ops.scan import (_pad_lane, count_records_device,
                                             structural_bitmaps,
                                             structural_bitmaps_torch)

    err = 0
    n_cases = 0

    def compare(chunk, label):
        nonlocal err, n_cases
        got = structural_bitmaps(chunk)
        want = structural_bitmaps_torch(chunk)
        torch.cuda.synchronize()
        err = max(err, max_abs_diff(got, want, "scan kernel, " + label))
        n_cases += 1
        return want

    rec, _ = _make_block(seed, 10 ** 6 + 1, 0, PARSE_CHUNK // RS, False)
    host = rec.reshape(-1)
    big = _pad_lane(torch.from_numpy(host).cuda())
    compare(big, "256 MiB of records")
    soup = np.random.default_rng([seed, 5]).choice(
        np.frombuffer(b"\n@+A", np.uint8), 64 << 20)
    compare(torch.from_numpy(soup).cuda(), "64 MiB of '\\n@+A'")
    pairs = np.frombuffer(b"".join(bytes([v, c]) for c in b"\n@+"
                                   for v in range(256)), np.uint8)
    compare(torch.from_numpy(np.tile(pairs, 4)).cuda(),
            "every byte beside each class byte")
    for off in (1, 5, 16):
        compare(big[off:off + (64 << 20)], "a view %d bytes in" % off)
    for first, n in ((0, 1), (0, 127), (0, 129), (0, 128 * 1024 + 5),
                     (3, 128 * 4096)):
        want = compare(_pad_lane(big[first:first + n]),
                       "N=%d from %d" % (n, first))
        got = count_records_device(big[first:first + n])
        expect = int(np.count_nonzero(host[first:first + n] == 10)) // 4
        if (got.dtype != torch.int32 or got.dim() != 0
                or int(got) != expect
                or int(want[3].sum()) // 4 != expect):
            raise AssertionError("count_records_device(N=%d from %d): %r, "
                                 "want %d" % (n, first, got, expect))
    ms = cuda_ms(lambda: structural_bitmaps(big))
    plain_ms = cuda_ms(lambda: structural_bitmaps_torch(big), inner=2)
    # three byte-class tests per 4-byte word
    bnd = bound(nbytes(big, *structural_bitmaps(big)), 3 * big.numel() // 4)
    log("scan kernel == plain on %d cases; 256 MiB chunk: kernel %.4f ms "
        "(%.1f GB/s), plain %.3f ms, bound %.4f ms (%s)" % (
            n_cases, ms, big.numel() / ms / 1e6, plain_ms, bnd["bound_ms"],
            bnd["bound_by"]))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **bnd)


def ragged_fill(c, n, width):
    """The zero fill that each ragged_qc call on chunk c (n valid bytes)
    makes before its kernel (the raw outputs, one status word per tile and
    the tile counter), as a call of its own, for its device time."""
    import importlib

    import torch

    rqc = importlib.import_module("blazeseq_tpu_torch.ops.ragged_qc")
    size = sum(rqc.raw_sizes(width)) + rqc.tile_count(c.data_ptr(), n) + 1
    return lambda: torch.zeros(size, dtype=torch.int32, device=c.device)


def ragged_scratch_bytes(raw_fn, c, n, **kw):
    """Device memory one raw_fn(c, n, **kw) call allocates beyond what was
    allocated before it (the chunk among it): its peak, outputs included."""
    import torch

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    raw_fn(c, n, **kw)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - before


def phase_kernel_ragged(seed, tmp):
    """The ragged kernel (bs_ragged_qc, one pass after a zero fill) against
    its plain version on the card, every output leaf exact: the cases of
    RAGGED_EDGE_CASES, then 256 MiB of the ragged corpus's generator (its
    reads and tail against the generator's record starts; the chunk
    kernel_bench.py times), which is timed with the fill's own time, the
    call's device-memory scratch and the kernel's blocks per SM beside
    it."""
    import torch

    from blazeseq_tpu_torch import _kernels
    from blazeseq_tpu_torch.ops.ragged_qc import (_ragged_qc_raw_cuda,
                                                  _ragged_qc_raw_torch,
                                                  ragged_qc, ragged_qc_torch,
                                                  raw_sizes)

    err = 0

    def compare(c, n_valid, kw, label):
        nonlocal err
        got = ragged_qc(c, n_valid, **kw)
        want = ragged_qc_torch(c, n_valid, **kw)
        torch.cuda.synchronize()
        err = max(err, max_abs_diff(
            (got.ok, got.fallback, got.tail_start, *got.stats),
            (want.ok, want.fallback, want.tail_start, *want.stats),
            "ragged kernel, " + label))
        return want

    for label in RAGGED_EDGE_CASES:
        host, off, n_valid, kw = ragged_edge_case(label, seed)
        dev = torch.zeros(len(host) + off, dtype=torch.uint8, device="cuda")
        dev[off:].copy_(torch.from_numpy(host))
        want = compare(dev[off:], n_valid, kw, label)
        if bool(want.ok) == label.startswith("invalid"):
            raise AssertionError("ragged kernel, %s: ok is %s"
                                 % (label, bool(want.ok)))
    path = os.path.join(tmp, "ragged_chunk.fastq")
    _, starts = write_ragged_corpus(path, PARSE_CHUNK, seed + 23)
    c = torch.from_numpy(np.fromfile(path, np.uint8)).cuda()
    os.unlink(path)
    n = c.numel()
    kw = dict(width=QC_WIDTH, q_lo=33, q_hi=126, offset=33,
              check_ascii=True, check_quality=True)
    want = compare(c, n, kw, "256 MiB chunk")
    n_rec = len(starts) - 1
    if not (bool(want.ok) and int(want.stats.reads) == n_rec
            and int(want.tail_start) == starts[n_rec] == n):
        raise AssertionError("ragged kernel, 256 MiB chunk: ok %s, %d reads "
                             "to %d, want %d to %d" % (
                                 bool(want.ok), int(want.stats.reads),
                                 int(want.tail_start), n_rec, starts[n_rec]))
    scratch = ragged_scratch_bytes(_ragged_qc_raw_cuda, c, n, **kw)
    ms = cuda_ms(lambda: _ragged_qc_raw_cuda(c, n, **kw), inner=3)
    notes = dict(fill_ms=cuda_ms(ragged_fill(c, n, QC_WIDTH), inner=3),
                 scratch_bytes=scratch,
                 blocks_per_sm=_kernels.load().bs_ragged_qc_blocks_per_sm(
                     QC_WIDTH))
    plain_ms = cuda_ms(lambda: _ragged_qc_raw_torch(c, n, **kw), inner=1,
                       trials=3)
    # reads the chunk once and writes its raw sums; at least one
    # operation per byte
    bnd = bound(n + 4 * sum(raw_sizes(QC_WIDTH)), n)
    log("ragged kernel == plain on %d cases; 256 MiB chunk (%d records, "
        "%d bytes): kernel %.4f ms (%.1f GB/s; its zero fill %.4f ms, %d "
        "blocks an SM), scratch %d bytes beyond the chunk, plain %.1f ms, "
        "bound %.4f ms (%s), share %.1f%%" % (
            len(RAGGED_EDGE_CASES) + 1, n_rec, n, ms, n / ms / 1e6,
            notes["fill_ms"], notes["blocks_per_sm"],
            scratch, plain_ms, bnd["bound_ms"], bnd["bound_by"],
            100 * bnd["bound_ms"] / ms))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **bnd), notes


KERNEL_PARSE_SOURCE = "blazeseq_tpu_torch/csrc/parse.cu"
# the device-parse kernels: (JSON name, the wrapper's attribute in its
# module, the reference lines it replaces)
PARSE_KERNELS = (
    ("raw_stream_qc", "blazeseq_tpu/ops/raw_stats.py:64-127"),
    ("newline_positions", "blazeseq_tpu/ops/scan.py:98-135"),
    ("record_offsets", "blazeseq_tpu/ops/scan.py:138-176"),
    ("gather_padded", "blazeseq_tpu/ops/scan.py:179-196"),
    ("count_records", "blazeseq_tpu/ops/scan.py:216-228"),
)


def storage_bytes(*tensors):
    """Bytes of the distinct storages under the tensors."""
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def call_scratch_bytes(fn):
    """Device memory one fn() call allocates at its peak beyond what was
    allocated before it and the storages of what it returns."""
    import torch

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    return peak - storage_bytes(*out)


def device_parse_calls(chunk, max_records, max_len, max_count, start=0,
                       offsets=None, qc=(33, 126, 33, 64)):
    """The device-parse functions on one chunk, each as (kernel call,
    plain call), by PARSE_KERNELS' names. gather_padded takes `offsets`,
    else the plain record pass's."""
    import blazeseq_tpu_torch.ops.raw_stats as rs
    import blazeseq_tpu_torch.ops.scan as sc

    calls = dict(
        raw_stream_qc=(lambda: rs.raw_stream_qc(chunk, *qc),
                       lambda: rs.raw_stream_qc_torch(chunk, *qc)),
        newline_positions=(
            lambda: sc.newline_positions_device(chunk, max_count),
            lambda: sc.newline_positions_torch(chunk, max_count)),
        count_records=(lambda: (sc.count_records_device(chunk),),
                       lambda: (sc.count_records_torch(chunk),)))
    if chunk.numel():  # the plain record pass cannot take an empty chunk
        if offsets is None:
            offsets = sc.record_offsets_torch(chunk, max_records, start)[0]
        calls.update(
            record_offsets=(
                lambda: sc.record_offsets_device(chunk, max_records, start),
                lambda: sc.record_offsets_torch(chunk, max_records, start)),
            gather_padded=(
                lambda: sc.gather_padded_device(chunk, offsets, max_records,
                                                max_len),
                lambda: sc.gather_padded_torch(chunk, offsets, max_records,
                                               max_len)))
    return calls, offsets


def device_parse_bounds(chunk, calls, offsets, max_records, max_len):
    """bound() of each device-parse function on this chunk: each reads the
    chunk once (or, the gather, each in-row byte) and writes its outputs
    once; at least one operation a byte read."""
    import torch

    n = chunk.numel()
    out = {}
    for name, (kernel, _) in calls.items():
        outs = storage_bytes(*kernel())
        if name == "gather_padded":
            o = offsets.to(torch.int64)
            lens = torch.where(o[:, 0] >= 0, o[:, 2] - o[:, 1] - 1, 0)
            read = 2 * int(lens.clamp(0, max_len).sum()) + nbytes(offsets)
        else:
            read = n
        out[name] = bound(read + outs, read)
    return out


def phase_kernel_device_parse(seed, tmp):
    """The device-parse kernels of csrc/parse.cu (raw_stream_qc, the newline
    compaction, the record pass, the padded gather, the record count)
    against their plain versions on the card, every output leaf exact: the
    cases of DEVICE_PARSE_EDGE_CASES, the card-only MANY_TILE_CASES at
    each of MANY_TILE_OFFSETS, MANY_TILE_RUNS times, then a 256 MiB chunk
    of the ragged
    corpus's generator at device_parse's shape (3,121,343 rows x 300
    columns) and a 256 MiB chunk of uniform records at 150 columns (rows of
    an odd stride for the gather's stores). On the ragged chunk each is
    timed against its plain version, with its bound and the scratch of
    each (peak device memory beyond the chunk and the outputs)."""
    import torch

    err = 0
    n_cases = 0

    def compare(calls, label):
        nonlocal err, n_cases
        for name, (kernel, plain) in calls.items():
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            err = max(err, max_abs_diff(got, want, "%s, %s" % (name, label)))
            n_cases += 1

    for label in DEVICE_PARSE_EDGE_CASES:
        case = device_parse_edge_case(label, seed)
        off = case["off"]
        dev = torch.zeros(len(case["data"]) + off, dtype=torch.uint8,
                          device="cuda")
        dev[off:].copy_(torch.from_numpy(case["data"]))
        offs = case["offsets"]
        calls, _ = device_parse_calls(
            dev[off:], case["max_records"], case["max_len"],
            case["max_count"], case["start"],
            None if offs is None else torch.from_numpy(offs).cuda(),
            tuple(case[k] for k in ("q_lower", "q_upper", "offset",
                                    "max_phred")))
        compare(calls, label)
    for label in MANY_TILE_CASES:
        data = device_parse_many_tiles(label, seed)
        max_records = int(np.count_nonzero(data == 10)) // 4 + 3
        for off in MANY_TILE_OFFSETS:
            dev = torch.zeros(len(data) + off, dtype=torch.uint8,
                              device="cuda")
            dev[off:].copy_(torch.from_numpy(data))
            calls, _ = device_parse_calls(dev[off:], max_records, 64,
                                          4 * max_records + 2)
            for name, (kernel, plain) in calls.items():
                want = plain()
                for _ in range(MANY_TILE_RUNS):
                    got = kernel()
                    torch.cuda.synchronize()
                    err = max(err, max_abs_diff(got, want, "%s, %s, view %d "
                                                "bytes in" % (name, label,
                                                              off)))
                    n_cases += 1
            del dev, calls
    path = os.path.join(tmp, "parse_chunk.fastq")
    write_ragged_corpus(path, PARSE_CHUNK, seed + 23)
    ragged = torch.from_numpy(np.fromfile(path, np.uint8)).cuda()
    os.unlink(path)
    rec, _ = _make_block(seed, 10 ** 6 + 1, 0, PARSE_CHUNK // RS, False)
    uniform = torch.from_numpy(rec.reshape(-1)).cuda()
    del rec
    shapes = dict(ragged=(ragged, PARSE_CHUNK // RAGGED_MIN_RECORD + 1,
                          RAGGED_LEN[1]),
                  uniform=(uniform, PARSE_CHUNK // RS + 1, READ_LEN))
    out, notes = {}, {}
    for label, (c, max_records, max_len) in shapes.items():
        calls, offsets = device_parse_calls(c, max_records, max_len,
                                            4 * max_records)
        compare(calls, "256 MiB %s chunk" % label)
        if label != "ragged":
            continue
        bounds = device_parse_bounds(c, calls, offsets, max_records,
                                     max_len)
        for name, (kernel, plain) in calls.items():
            out[name] = dict(
                max_abs_err=err, ms=cuda_ms(kernel, inner=5),
                plain_ms=cuda_ms(plain, inner=1, trials=3), **bounds[name])
            notes[name] = dict(scratch_bytes=call_scratch_bytes(kernel),
                               plain_scratch_bytes=call_scratch_bytes(plain))
        del calls, offsets
    # a chunk's device-parse calls as the device_parse path makes them
    import blazeseq_tpu_torch.ops.raw_stats as rs
    import blazeseq_tpu_torch.ops.scan as sc

    max_records = shapes["ragged"][1]
    notes["chunk_ms"] = cuda_ms(lambda: (
        rs.raw_stream_qc(ragged, 33, 126, 33),
        sc.parse_fastq_device(ragged, max_records, RAGGED_LEN[1])), inner=3)
    del shapes, ragged, uniform
    log("device-parse kernels == plain on %d comparisons (%d edge cases, "
        "%d card-only cases of 1,024 tiles and more at views 0, 1, 13 bytes "
        "in, %d runs each, two 256 MiB chunks); the ragged chunk: %s; "
        "raw_stream_qc + parse_fastq_device %.4f ms a chunk" % (
            n_cases, len(DEVICE_PARSE_EDGE_CASES), len(MANY_TILE_CASES),
            MANY_TILE_RUNS,
            "; ".join("%s %.4f ms (plain %.3f, bound %.4f, %s; scratch %d "
                      "bytes, plain %d)" % (
                          k, v["ms"], v["plain_ms"], v["bound_ms"],
                          v["bound_by"], notes[k]["scratch_bytes"],
                          notes[k]["plain_scratch_bytes"])
                      for k, v in out.items()), notes["chunk_ms"]))
    return out, notes


def _time_stream_tiers(model):
    """Instrument `model`'s stream tiers for one run: time spent in the
    reader's readinto, and the moment the ragged stream tier starts. Call
    the returned function with the run's start time after the run; it
    undoes the instrumentation and returns both."""
    from blazeseq_tpu_torch.models import qc as qc_mod

    opened, ragged = qc_mod.open_reader, model._run_ragged_stream
    waited, started = [0.0], []

    class TimedReader:
        def __init__(self, inner):
            self._inner = inner

        def readinto(self, mv):
            t = time.perf_counter()
            try:
                return self._inner.readinto(mv)
            finally:
                waited[0] += time.perf_counter() - t

        def close(self):
            self._inner.close()

    def ragged_stream(*a):
        started.append(time.perf_counter())
        return ragged(*a)

    qc_mod.open_reader = lambda p, parallelism=4: TimedReader(
        opened(p, parallelism=parallelism))
    model._run_ragged_stream = ragged_stream

    def done(t0):
        qc_mod.open_reader = opened
        del model._run_ragged_stream
        return dict(reader_wait_s=waited[0],
                    ragged_from_s=started[0] - t0 if started else None)
    return done


def _device_and_host(path, oracle, size, label, tier, keep=None):
    """run_file_device on the card, checked against the oracle and routed
    wholly through `tier`, then run_file (the host route) on the same file
    in the same call, every panel equal. `size` is the FASTQ's size: for a
    compressed file, its size once inflated, and the inflate alone is timed
    too. `keep` (a dict) takes run_file_device's report and wall time."""
    import torch

    from blazeseq_tpu_torch import QCModel
    from blazeseq_tpu_torch.io.readers import open_reader

    # one plain read of the file first: its time shows whether the page
    # cache holds the file (the metric is taken with a warm cache)
    t0 = time.perf_counter()
    buf = bytearray(64 << 20)
    with open(path, "rb", buffering=0) as f:
        while f.readinto(buf):
            pass
    read_s = time.perf_counter() - t0
    stream = {}
    if path.endswith((".gz", ".bgz")):
        # the inflate alone: the reader run_file_device opens, drained
        t0 = time.perf_counter()
        reader = open_reader(path, 4)
        n, view = 0, memoryview(buf)
        try:
            while True:
                k = reader.readinto(view)
                if not k:
                    break
                n += k
        finally:
            reader.close()
        inflate_s = time.perf_counter() - t0
        if n != size:
            raise AssertionError("%s: %d bytes inflated, %d expected"
                                 % (label, n, size))
        stream = dict(compressed_bytes=os.path.getsize(path),
                      inflate_s=inflate_s, inflate_gbps=size / inflate_s / 1e9)
        log("%s: %d compressed bytes, %d inflated; the inflate alone %.3f "
            "s, %.3f GB/s of inflated bytes" % (
                label, stream["compressed_bytes"], size, inflate_s,
                stream["inflate_gbps"]))
    model = QCModel(quality_schema="sanger", device="cuda")
    if stream:
        # where a stream's time goes: the tiers' wait in the reader (the
        # inflate), and when a uniform proof failure handed the rest to the
        # ragged stream tier (one Python frame more per readinto call, each
        # of which serves up to a 64 KiB block inflated)
        timers = _time_stream_tiers(model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        rep = model.run_file_device(path)
        torch.cuda.synchronize()
    finally:
        if stream:
            stream.update(timers(t0))
    wall = time.perf_counter() - t0
    check_report(rep, oracle, model.max_read_len)
    if keep is not None:
        keep.update(report=rep, wall_s=wall)
    tiers = model.tier_chunks
    if tiers[tier] == 0 or any(v for k, v in tiers.items() if k != tier):
        raise AssertionError("%s: expected %s chunks only, got %s"
                             % (label, tier, tiers))
    t0 = time.perf_counter()
    host = QCModel(quality_schema="sanger", device="cuda").run_file(path)
    torch.cuda.synchronize()
    host_wall = time.perf_counter() - t0
    _same_reports(rep, host, label + ", run_file_device vs run_file")
    log("%s: %d bytes, %d reads, %d bases (a plain read of the file %.3f "
        "s): run_file_device %.3f s, %.3f GB/s (tier_chunks %s); run_file "
        "(host route) %.3f s, %.3f GB/s; reports equal" % (
            label, size, rep.reads, rep.bases, read_s, wall,
            size / wall / 1e9, tiers, host_wall, size / host_wall / 1e9))
    if stream:
        log("%s: run_file_device waited %.3f s in the reader; the ragged "
            "stream tier took over at %s" % (
                label, stream["reader_wait_s"],
                "no point" if stream["ragged_from_s"] is None
                else "%.3f s" % stream["ragged_from_s"]))
    return dict(bytes=size, read_s=read_s, wall_s=wall, gbps=size / wall / 1e9,
                chunks=tiers[tier], host_wall_s=host_wall,
                host_gbps=size / host_wall / 1e9, **stream)


def phase_semi(seed, tmp):
    """A 1 GiB semi-uniform FASTQ (150 bp reads, ids of varying width)
    through run_file_device on the card: every chunk on the semi tier,
    against the numpy oracle and run_file."""
    path = os.path.join(tmp, "semi.fastq")
    t0 = time.perf_counter()
    oracle = write_semi_corpus(path, SEMI_BYTES // RS, seed + 29)
    size = os.path.getsize(path)
    log("semi corpus: %d records, %d bytes, written in %.1f s"
        % (oracle["reads"], size, time.perf_counter() - t0))
    try:
        return _device_and_host(path, oracle, size, "run_file_device(semi)",
                                "semi")
    finally:
        os.unlink(path)


def phase_gzip(seed, tmp):
    """A 1 GiB uniform FASTQ compressed as one gzip member through
    run_file_device on the card: every chunk on the uniform stream tier,
    against the numpy oracle and run_file on the same .gz."""
    need = GZIP_BYTES + (GZIP_BYTES >> 1) + (256 << 20)
    free = shutil.disk_usage(tmp).free
    if free < need:
        raise RuntimeError("the gzip path needs %d free bytes in %s, found "
                           "%d" % (need, tmp, free))
    plain = os.path.join(tmp, "gzip.fastq")
    path = plain + ".gz"
    n = GZIP_BYTES // RS
    try:
        t0 = time.perf_counter()
        oracle = write_corpus(plain, n, seed + 31)
        t1 = time.perf_counter()
        comp = write_compressed(plain, path, "gzip")
        log("gzip corpus: %d records of %d bytes written in %.1f s, "
            "compressed to %d bytes (one gzip member, level 1) in %.1f s"
            % (n, RS, t1 - t0, comp, time.perf_counter() - t1))
        os.unlink(plain)
        return _device_and_host(path, oracle, n * RS,
                                "run_file_device(gzip)", "uniform")
    finally:
        for p in (plain, path):
            if os.path.exists(p):
                os.unlink(p)


def phase_bgzf_ragged(ragged, tmp):
    """The 1 GiB ragged FASTQ written as BGZF through run_file_device on the
    card: every chunk on the ragged stream tier, against the numpy oracle
    and run_file on the same .bgz."""
    src, oracle, _ = ragged
    need = (oracle["bytes"] >> 1) + (256 << 20)
    free = shutil.disk_usage(tmp).free
    if free < need:
        raise RuntimeError("the BGZF path needs %d free bytes in %s, found "
                           "%d" % (need, tmp, free))
    path = os.path.join(tmp, "ragged.fastq.bgz")
    try:
        t0 = time.perf_counter()
        comp = write_compressed(src, path, "bgzf")
        log("ragged corpus compressed to %d bytes of BGZF (level 6) in "
            "%.1f s" % (comp, time.perf_counter() - t0))
        return _device_and_host(path, oracle["window"], oracle["bytes"],
                                "run_file_device(bgzf ragged)", "ragged")
    finally:
        if os.path.exists(path):
            os.unlink(path)


def phase_ragged(ragged, keep):
    """The 1 GiB ragged FASTQ through run_file_device on the card: every
    chunk on the ragged tier, against the numpy oracle and run_file. The
    report goes into keep["ragged_device"] for the mesh path."""
    path, oracle, _ = ragged
    keep["ragged_device"] = {}
    return _device_and_host(path, oracle["window"], oracle["bytes"],
                            "run_file_device(ragged)", "ragged",
                            keep["ragged_device"])


def make_ragged_corpus(seed, tmp):
    """The 1 GiB ragged corpus, written once for run_file_device(ragged)
    and the device_parse path: (path, oracle, record starts)."""
    path = os.path.join(tmp, "ragged.fastq")
    t0 = time.perf_counter()
    oracle, starts = write_ragged_corpus(path, RAGGED_BYTES, seed + 23)
    log("ragged corpus: %d records, %d bytes, written in %.1f s"
        % (oracle["reads"], oracle["bytes"], time.perf_counter() - t0))
    return path, oracle, starts


def phase_device_parse(seed, ragged):
    """The device-parse API on the 1 GiB ragged FASTQ fed in 256 MiB chunks:
    raw_stream_qc, count_records_device(chunk[:tail_start]) == reads, and
    parse_fastq_device; the partial tail goes to the next chunk. Totals
    against the host parser, composition and Phred histogram against the
    generator, every code 0, 2,000 sampled rows against the host parser's
    bytes, and a planted '@' -> 'X' giving code 1 at its record."""
    import torch

    import blazeseq_tpu_torch as bt
    from blazeseq_tpu_torch.ops.raw_stats import raw_stream_qc
    from blazeseq_tpu_torch.ops.scan import (count_records_device,
                                             parse_fastq_device)

    path, oracle, starts = ragged
    n_total = oracle["reads"]
    data = np.memmap(path, np.uint8, "r")
    max_records = PARSE_CHUNK // RAGGED_MIN_RECORD + 1
    max_len = RAGGED_LEN[1]
    sample = np.sort(np.random.default_rng([seed, 6]).choice(
        n_total, TWIN_SAMPLE, replace=False))
    pinned = torch.empty(PARSE_CHUNK, dtype=torch.uint8).pin_memory()
    dev = torch.empty(PARSE_CHUNK, dtype=torch.uint8, device="cuda")
    tot = dict(reads=0, bases=0, base_counts=np.zeros(5, np.int64),
               qual_hist=np.zeros(64, np.int64))
    rows = []
    pos = rec0 = chunks = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while pos < len(data):
        m = min(PARSE_CHUNK, len(data) - pos)
        pinned.numpy()[:m] = data[pos:pos + m]
        chunk = dev[:m]
        chunk.copy_(pinned[:m], non_blocking=True)
        raw = raw_stream_qc(chunk, 33, 126, 33)
        tail = int(raw.tail_start)
        reads = int(raw.reads)
        if tail == 0 or any(bool(f) for f in (
                raw.bad_structure, raw.seq_qual_mismatch, raw.bad_ascii,
                raw.bad_quality)):
            raise AssertionError("device_parse: chunk at %d: %r"
                                 % (pos, raw))
        body = chunk[:tail]
        counted = int(count_records_device(body))
        seq, qual, lengths, n_rec, codes = parse_fastq_device(
            body, max_records, max_len)
        if not counted == int(n_rec) == reads <= max_records:
            raise AssertionError(
                "device_parse: chunk at %d: raw_stream_qc %d reads, "
                "count_records_device %d, parse_fastq_device %d (rows %d)"
                % (pos, reads, counted, int(n_rec), max_records))
        if bool((codes != 0).any()):
            raise AssertionError("device_parse: nonzero structure codes")
        tot["reads"] += reads
        tot["bases"] += int(raw.bases)
        tot["base_counts"] += raw.base_counts.cpu().numpy()
        tot["qual_hist"] += raw.qual_hist.cpu().numpy()
        local = sample[(sample >= rec0) & (sample < rec0 + reads)] - rec0
        idx = torch.from_numpy(local).cuda()
        rows.append([t.index_select(0, idx).cpu().numpy()
                     for t in (seq, qual, lengths)])
        del seq, qual, lengths, codes
        rec0 += reads
        pos += tail
        chunks += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    host_reads, host_bases = bt.FastqParser(bt.open_reader(path)).count()
    want = dict(reads=host_reads, bases=host_bases,
                base_counts=oracle["base_counts"],
                qual_hist=oracle["qual_hist"])
    for k, v in want.items():
        if not np.array_equal(tot[k], v):
            raise AssertionError("device_parse: %s %r, want %r"
                                 % (k, tot[k], v))
    if host_reads != n_total or host_bases != oracle["bases"]:
        raise AssertionError("device_parse: the host parser counts %d "
                             "reads / %d bases, the generator %d / %d"
                             % (host_reads, host_bases, n_total,
                                oracle["bases"]))
    seq, qual, lengths = (np.concatenate(c) for c in zip(*rows))
    for k, i in enumerate(sample.tolist()):
        r = bt.FastqParser(bt.MemoryReader(
            bytes(data[starts[i]:starts[i + 1]]))).next_batch(1)
        r = r.get_record(0)
        L = int(lengths[k])
        if (L != len(r) or seq[k, :L].tobytes() != r.sequence_bytes()
                or qual[k, :L].tobytes() != r.quality_bytes()
                or seq[k, L:].any() or qual[k, L:].any()):
            raise AssertionError("device_parse: record %d differs from the "
                                 "host parser's" % i)
    # one corruption in a small copy
    bad = np.array(data[:starts[4000]])
    bad[starts[1234]] = ord("X")
    c = torch.from_numpy(bad).cuda()
    _, _, _, n_rec, codes = parse_fastq_device(c, 4096, max_len)
    codes = codes.cpu().numpy()
    if (int(n_rec) != 4000 or codes[1234] != 1
            or np.count_nonzero(codes) != 1
            or not bool(raw_stream_qc(c, 33, 126, 33).bad_structure)):
        raise AssertionError("device_parse: the planted '@' -> 'X' gave "
                             "codes %s" % np.flatnonzero(codes))
    del data
    size = oracle["bytes"]
    log("device_parse: %d bytes, %d reads, %d bases in %d chunks: %.3f s "
        "wall, %.3f GB/s; totals == host parser, composition and Phred "
        "histogram == generator, %d sampled rows == host parser, planted "
        "corruption -> code 1" % (size, tot["reads"], tot["bases"], chunks,
                                  wall, size / wall / 1e9, TWIN_SAMPLE))
    return dict(bytes=size, reads=tot["reads"], wall_s=wall,
                gbps=size / wall / 1e9)


def merge_batch_pair(files, device="cuda"):
    """The first batch pair of the merge mates as the merge command makes
    it: MERGE_BATCH records of each file, padded by to_padded to one width
    (the longer mate's, rounded up to 128), on `device`; (seq1, qual1,
    len1, seq2, qual2, len2)."""
    from blazeseq_tpu_torch.fastq.batch import padded_to_device
    from blazeseq_tpu_torch.fastq.parser import FastqParser
    from blazeseq_tpu_torch.io.readers import open_reader

    batches = [FastqParser(open_reader(files[k])).next_batch(MERGE_BATCH)
               for k in ("r1", "r2")]
    width = max(int(np.diff(b._ends, prepend=0).max()) for b in batches)
    out = []
    for b in batches:
        pb = padded_to_device(b.to_padded(max_len=width), device)
        out += [pb.seq, pb.qual, pb.lengths]
    return tuple(out)


def phase_kernel_merge(seed, files):
    """csrc/merge.cu against merge_pairs_torch on the card, every
    MergeResult leaf exact: MERGE_EDGE_CASES, MERGE_CARD_CASES and the
    first batch pair of the merge mates (250,000 pairs of 150 bp mates of
    200 bp fragments, padded to 256 columns), on which the kernel and its
    plain version are timed beside the bound; the kernel is also timed on
    the MiSeq card case (4,096 x 384)."""
    import torch

    from blazeseq_tpu_torch.ops import merge

    n_cases = 0
    miseq = {}
    for label in MERGE_EDGE_CASES + MERGE_CARD_CASES:
        arrays, kw = merge_edge_case(label, seed)
        d = [torch.from_numpy(a).cuda() for a in arrays]
        max_abs_diff(merge.merge_pairs(*d, **kw),
                     merge.merge_pairs_torch(*d, **kw),
                     "merge_pairs, " + label)
        n_cases += 1
        if label == MERGE_CARD_CASES[3]:
            # the second timed shape: MiSeq amplicon mates
            miseq = dict(ms_4096x384=cuda_ms(lambda: merge.merge_pairs(*d)),
                         bound_ms_4096x384=merge_bound(
                             arrays[2], arrays[5], 384)["bound_ms"])
    d = merge_batch_pair(files)
    got = merge.merge_pairs(*d)
    err = max_abs_diff(got, merge.merge_pairs_torch(*d),
                       "merge_pairs, the first batch pair")
    n, L = d[0].shape
    merged = int((got.overlap > 0).sum())
    rec = dict(shape="%dx%d" % (n, L), merged=merged, cases=n_cases + 1,
               ms=cuda_ms(lambda: merge.merge_pairs(*d)),
               plain_ms=cuda_ms(lambda: merge.merge_pairs_torch(*d), inner=1,
                                trials=3),
               max_abs_err=err, **miseq,
               **merge_bound(d[2].cpu().numpy(), d[5].cpu().numpy(), L))
    log("merge_pairs %s (%d of %d pairs merged): kernel %.4f ms, plain %.4f "
        "ms, bound %.5f ms (%s); 4096x384: kernel %.4f ms, bound %.5f ms; "
        "== plain on %d cases"
        % (rec["shape"], merged, n, rec["ms"], rec["plain_ms"],
           rec["bound_ms"], rec["bound_by"], rec["ms_4096x384"],
           rec["bound_ms_4096x384"], rec["cases"]))
    return rec


def cli_file_batch(path, n):
    """The first n reads of a FASTQ file as the CLI pads them (to_padded:
    the batch's longest read rounded up to 128) on the card, with their
    tile numbers: (tiles, seq, qual, lengths, n_records)."""
    from blazeseq_tpu_torch.fastq.batch import padded_to_device
    from blazeseq_tpu_torch.fastq.parser import FastqParser
    from blazeseq_tpu_torch.io.readers import open_reader
    from blazeseq_tpu_torch.ops.tiles import parse_illumina_tiles

    batch = FastqParser(open_reader(path)).next_batch(n)
    batch._finalize()
    pb = padded_to_device(batch.to_padded(), "cuda")
    return (parse_illumina_tiles(batch._id_bytes, batch._id_ends), pb.seq,
            pb.qual, pb.lengths, pb.n_records)


# the CLI's options of each call timed: trim's defaults in each mode,
# demux --mismatches 1 on the planted barcodes, the tiles panel; kmer at
# the analysis example's k = 4
CLI_OP_TIMED = (
    ("trim", "sliding_window_trim", dict(mean_q=15, window=4)),
    ("trim", "bwa_trim", dict(threshold=20)),
    ("trim", "clip_ends", dict(leading=3, trailing=3)),
    ("demux", "demux_assign", dict(barcodes=DEMUX_BARCODES,
                                   max_mismatches=1)),
    ("tiles", "per_tile_qual_sums", dict(offset=33)),
    ("kmer", "kmer_counts", dict(k=4)))


def _timed_cli_op(op, fn, kw, d):
    """(the op's call, its plain version's or None, bound, the whole call or
    None) of one CLI_OP_TIMED entry on the tensors d. The tiles kernel is
    timed as its launch alone, on a row map already on the card into an
    output already made (the whole call also maps the rows on the host,
    uploads the map, copies the sums back); in a tree whose kernel reads
    the rows grouped by tile (`_tile_order`), as that order's zero fill and
    launch. In a tree without the kernels (no `*_torch`), the op is its
    torch ops and there is no plain version."""
    import functools

    import torch

    from blazeseq_tpu_torch.ops import demux, kmer, tiles, trim

    mod = dict(trim=trim, demux=demux, tiles=tiles, kmer=kmer)[op]
    host = {k: (v if k == "tiles" else v.cpu().numpy()) for k, v in d.items()}
    kw = dict(kw)
    if op == "trim":
        args = (d["qual"], d["lengths"], 33)
        b = cli_op_bound(op, host, mode=fn)
    elif op == "demux":
        args = (d["seq"], d["lengths"], kw.pop("barcodes"),
                kw.pop("max_mismatches"))
        b = cli_op_bound(op, host, barcodes=DEMUX_BARCODES)
    elif op == "kmer":
        args = (d["seq"], d["lengths"])
        b = cli_op_bound(op, host, k=kw["k"])
    else:
        args = (d["tiles"], d["qual"], d["lengths"], kw.pop("offset"))
        b = cli_op_bound(op, host)
    call = functools.partial(getattr(mod, fn), *args, **kw)
    plain = getattr(mod, fn + "_torch", None)
    plain = plain and functools.partial(plain, *args, **kw)
    if op != "tiles" or not hasattr(tiles, "_tile_sums_launch"):
        return call, plain, b, None
    _, dst, rows = tiles._tile_rows(d["tiles"], len(d["tiles"]), None, None)
    L = d["qual"].shape[1]
    if hasattr(tiles, "_tile_order"):
        order = torch.from_numpy(tiles._tile_order(dst, rows)).cuda()

        def launch():
            out = torch.zeros((2, rows, L), dtype=torch.int64, device="cuda")
            tiles._tile_sums_launch(d["qual"], d["lengths"], order, out, 33)
        return launch, plain, b, call
    dst_card = torch.from_numpy(dst).cuda()
    out = torch.empty((2, rows, L), dtype=torch.float32, device="cuda")
    return (lambda: tiles._tile_sums_launch(d["qual"], d["lengths"],
                                            dst_card, out, 33),
            plain, b, call)


def device_work(fn):
    """torch.profiler's CUDA kernels and memsets of fn(), after a first,
    unprofiled call that makes any scratch: (kernel names, memset
    names)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    return ([x for x in names if not x.startswith("Mem")],
            [x for x in names if x.startswith("Memset")])


def tiles_library_call(d, offset=33):
    """The one PyTorch call that computes the tile sums, as the reference
    computes them (blazeseq_tpu/ops/tiles.py::_tile_contract): torch.mm of
    the one-hot [T, n] tile matrix by [n, 2L], the masked, capped Phred and
    the mask side by side, in float32 with TF32 off, its inputs made here
    (outside any timing). Returns (the call, a check that raises unless its
    result equals (sums, counts) given as numpy arrays)."""
    import torch

    from blazeseq_tpu_torch.ops import tiles
    from blazeseq_tpu_torch.ops.stats import MAX_PHRED

    torch.backends.cuda.matmul.allow_tf32 = False
    qual, lengths = d["qual"], d["lengths"]
    n, L = qual.shape
    _, dst, rows = tiles._tile_rows(d["tiles"], n, None, None)
    dst = torch.from_numpy(dst.astype(np.int64)).to(qual.device)
    onehot = torch.zeros((rows + 1, n), dtype=torch.float32,
                         device=qual.device)
    onehot[dst, torch.arange(n, device=qual.device)] = 1
    onehot = onehot[:rows].contiguous()
    mask = (torch.arange(L, device=qual.device)[None, :]
            < lengths.to(torch.int64)[:, None])
    q = qual.to(torch.int64)
    phred = torch.where(mask & (q >= offset), q - offset, 0).clamp_(
        max=MAX_PHRED - 1)
    rhs = torch.cat([phred, mask], 1).to(torch.float32).contiguous()

    def call():
        return torch.mm(onehot, rhs)

    def check(sums, counts):
        got = call().cpu().numpy()
        if not (np.array_equal(got[:, :L], sums)
                and np.array_equal(got[:, L:], counts)):
            raise AssertionError("the tiles library call differs from the "
                                 "plain sums")
    return call, check


def phase_kernel_cli_ops(seed, files):
    """csrc/trim.cu, demux.cu, tiles.cu and kmer.cu against their plain
    torch versions on the card, every leaf exact: CLI_OP_EDGE_CASES (at
    views 0, 1 and 13 bytes off alignment), the first 4,096 reads of the
    1M-read file as the CLI pads them (150 bp to 256 columns; demux also
    its own 16,384-read batch) and a 32,768 x 1,024 batch; each call of
    CLI_OP_TIMED timed at both shapes (demux at 16,384 x 256 and 32,768 x
    1,024) beside its plain version and its bound (the tile sums also
    beside torch.mm, tiles_library_call); kmer_counts at every k on random
    and poly-G rows and demux_assign on each of DEMUX_CARD_SETS at every
    CLI_OP_CARD_SHAPES and view; at the CLI's shape each trim mode, the
    tile sums, demux_assign and kmer_counts run one kernel a call and no
    fill (device_work).
    Returns a record a kernel source (trim: its three modes together, each
    under `modes`)."""
    import torch

    cases = 0
    for label in CLI_OP_EDGE_CASES:
        op, arrays, kw = cli_op_case(label, seed)
        for view in CLI_OP_VIEW_OFFSETS:
            d = cli_op_tensors(arrays, "cuda", view)
            for name, f, plain in cli_op_calls(op, d, kw):
                same_leaves(f(), plain(), "%s, %s, view %d"
                            % (label, name, view))
                cases += 1
    # every k, on random and on poly-G rows, and each barcode set of
    # DEMUX_CARD_SETS at every card shape and view
    for n, L in CLI_OP_CARD_SHAPES:
        kb = cli_op_card_batch("kmer", n, L, seed)
        poly = dict(kb, seq=np.full_like(kb["seq"], ord("G")))
        batches = [("kmer", kb, dict(n_records=None, ks=KMER_KS)),
                   ("kmer", poly, dict(n_records=None, ks=KMER_KS))]
        batches += [("demux", cli_op_card_batch("demux", n, L, seed, bcs),
                     dict(barcodes=bcs, max_mismatches=mms))
                    for _, bcs, mms in DEMUX_CARD_SETS]
        for op, arrays, kw in batches:
            for view in CLI_OP_VIEW_OFFSETS:
                d = cli_op_tensors(arrays, "cuda", view)
                for name, f, plain in cli_op_calls(op, d, kw):
                    same_leaves(f(), plain(), "%dx%d, %s, view %d"
                                % (n, L, name, view))
                    cases += 1
                del d
    head = cli_file_batch(files["align"], 4096)
    head_dm = cli_file_batch(files["align"], 16384)
    shapes = {}
    for op in ("trim", "demux", "tiles", "kmer"):
        src = head_dm if op == "demux" else head
        shapes[op] = [dict(zip(("tiles", "seq", "qual", "lengths"), src[:4]))]
        big = cli_op_card_batch(op, 32768, 1024, seed)
        shapes[op].append(cli_op_tensors(big, "cuda"))
    for op, fn, kw in CLI_OP_TIMED:
        if op in ("trim", "tiles", "demux", "kmer"):
            call = _timed_cli_op(op, fn, kw, shapes[op][0])[3 if op == "tiles"
                                                             else 0]
            kernels, fills = device_work(call)
            if len(kernels) != 1 or fills:
                raise AssertionError("%s: %s kernels and %s fills a call, "
                                     "want one kernel and no fill"
                                     % (fn, kernels, fills))
    recs = {}
    for op, fn, kw in CLI_OP_TIMED:
        for d in shapes[op]:
            call, plain, b, whole = _timed_cli_op(op, fn, kw, d)
            n, L = (d["qual"] if "qual" in d else d["seq"]).shape
            err = same_leaves((whole or call)(), plain(),
                              "%s on %dx%d" % (fn, n, L))
            cases += 1
            rec = dict(shape="%dx%d" % (n, L), ms=cuda_ms(call),
                       plain_ms=cuda_ms(plain, inner=1, trials=3),
                       max_abs_err=err, **b)
            if whole is not None:
                rec["call_ms"] = cuda_ms(whole, inner=3, trials=3)
            if op == "tiles":
                lib, check = tiles_library_call(d)
                check(*plain()[1:])
                rec["library_ms"] = cuda_ms(lib)
                del lib, check
            recs.setdefault(fn, []).append(rec)
            log("%s %s: kernel %.4f ms, plain %.4f ms, bound %.5f ms (%s)%s%s"
                % (fn, rec["shape"], rec["ms"], rec["plain_ms"],
                   rec["bound_ms"], rec["bound_by"],
                   ", whole call %.4f ms" % rec["call_ms"]
                   if whole is not None else "",
                   ", torch.mm %.4f ms" % rec["library_ms"]
                   if "library_ms" in rec else ""))
    torch.cuda.synchronize()
    log("CLI op kernels == plain on %d calls" % cases)

    def merged(fns):
        # the first shape's record summed over the calls, every record kept;
        # the tiles kernel's `ms` is its fill and launch alone, while
        # `plain_ms` is the plain version's whole call: its `call_ms`, the
        # kernel's whole call, is the time of the same scope
        first = [recs[f][0] for f in fns]
        out = dict(shape=first[0]["shape"], max_abs_err=0, cases=cases,
                   **{k: sum(r[k] for r in first)
                      for k in ("ms", "plain_ms", "bound_ms")})
        for k in ("call_ms", "library_ms"):
            if k in first[0]:
                out[k] = first[0][k]
        out["bound_by"] = first[0]["bound_by"]
        out["modes" if len(fns) > 1 else "shapes"] = {f: recs[f] for f in fns}
        return out

    return dict(trim=merged(("sliding_window_trim", "bwa_trim",
                             "clip_ends")),
                demux_assign=merged(("demux_assign",)),
                per_tile_qual_sums=merged(("per_tile_qual_sums",)),
                kmer_counts=merged(("kmer_counts",)))


def phase_analysis(files):
    """The analysis API as the reference's examples/analysis_panels.py
    drives it, over the 1M-read file in padded batches of 65,536 reads:
    bwa_trim, then kmer_counts (k = 4) before and after the trim with the
    batch's record count as a tensor on the card. Each batch's trimmed
    lengths must equal bwa_trim_torch's on CPU copies of its rows, and
    its counts before and after the trim a numpy oracle of its padded
    rows with those lengths; no count may rise with the trim."""
    import torch

    import blazeseq_tpu_torch as bt
    from blazeseq_tpu_torch.fastq.batch import padded_to_device
    from blazeseq_tpu_torch.io.readers import open_reader
    from blazeseq_tpu_torch.ops import bwa_trim, kmer_counts, trim

    lut = np.full(256, 4, np.int64)  # 0..3 for ACGTacgt, 4 otherwise
    for v, c in enumerate(b"ACGT"):
        lut[c] = lut[c | 0x20] = v

    def oracle(seq, lens, k=4):
        cls = lut[seq]
        n, L = seq.shape
        j = np.arange(L - k + 1)[None, :]
        ok = j + k <= np.minimum(lens, L)[:, None]
        code = np.zeros((n, L - k + 1), np.int64)
        for t in range(k):
            c = cls[:, t:L - k + 1 + t]
            ok &= c < 4
            code = code * 4 + c
        return np.bincount(code[ok], minlength=4 ** k)

    parser = bt.FastqParser(open_reader(files["align"]))
    before = torch.zeros(256, dtype=torch.int64, device="cuda")
    after = torch.zeros_like(before)
    batches = reads = 0
    t0 = time.perf_counter()
    while True:
        pb = parser.next_padded(1 << 16, max_len=256)
        if pb is None or pb.n_records == 0:
            break
        d = padded_to_device(pb, "cuda")
        nr = torch.tensor(pb.n_records, dtype=torch.int32, device="cuda")
        trimmed = bwa_trim(d.qual, d.lengths, 33, 20)
        kb = kmer_counts(d.seq, d.lengths, nr, k=4)
        ka = kmer_counts(d.seq, trimmed, nr, k=4)
        same_leaves((trimmed,), (trim.bwa_trim_torch(
            torch.from_numpy(np.ascontiguousarray(pb.qual)),
            torch.from_numpy(np.asarray(pb.lengths, np.int32)), 33, 20),),
            "analysis: batch %d's bwa_trim" % batches)
        rows = slice(0, pb.n_records)
        seq = np.asarray(pb.seq)[rows]
        if not np.array_equal(kb.cpu().numpy(),
                              oracle(seq, np.asarray(pb.lengths)[rows])):
            raise AssertionError("analysis: batch %d's 4-mers differ from "
                                 "the numpy oracle" % batches)
        if not np.array_equal(ka.cpu().numpy(),
                              oracle(seq, trimmed.cpu().numpy()[rows])):
            raise AssertionError("analysis: batch %d's trimmed 4-mers differ "
                                 "from the numpy oracle" % batches)
        if bool((ka > kb).any()):
            raise AssertionError("analysis: a 4-mer count rose with the "
                                 "trim")
        before += kb
        after += ka
        batches += 1
        reads += pb.n_records
    wall = time.perf_counter() - t0
    if reads != ALIGN_READS:
        raise AssertionError("analysis: %d reads" % reads)
    log("analysis: %d reads in %d batches, 4-mer windows %d -> %d after "
        "bwa_trim, %.3f s" % (reads, batches, int(before.sum()),
                              int(after.sum()), wall))
    return dict(reads=reads, batches=batches, wall_s=wall)


def _cli(argv, device, out_dir):
    """Run the port's CLI in-process; returns its stdout (out_dir masked),
    its output files' bytes and its wall time."""
    import contextlib
    import io

    import torch

    from blazeseq_tpu_torch.__main__ import main as cli_main

    os.makedirs(out_dir, exist_ok=True)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError("cli %s: exit %d" % (argv[0], rc))
    blobs = {}
    for root, _, names in os.walk(out_dir):
        for name in names:
            p = os.path.join(root, name)
            with open(p, "rb") as f:
                blobs[os.path.relpath(p, out_dir)] = f.read()
    return buf.getvalue().replace(out_dir, "{out}"), blobs, wall


def _head_records(path, k):
    """(id, seq, qual) of the first k records of a FASTQ file."""
    import blazeseq_tpu_torch as bt

    with open(path, "rb") as f:
        head = f.read(k * 4096)
    nl = np.flatnonzero(np.frombuffer(head, np.uint8) == 10)
    if len(nl) >= 4 * k > 0:
        head = head[:nl[4 * k - 1] + 1]  # whole records only
    b = bt.FastqParser(bt.MemoryReader(head)).next_batch(k)
    return [(r.id_bytes(), r.sequence_bytes(), r.quality_bytes())
            for r in (b.get_record(i) for i in range(min(k, len(b))))]


CLI_COMMANDS = (
    ("stats", ["stats", "{in}"]),
    ("stats --device", ["stats", "--device", "{in}"]),
    ("trim window", ["trim", "--mode", "window", "--out", "{out}/t.fastq",
                     "{in}"]),
    ("trim bwa", ["trim", "--mode", "bwa", "--out", "{out}/t.fastq", "{in}"]),
    ("trim ends", ["trim", "--mode", "ends", "--out", "{out}/t.fastq",
                   "{in}"]),
    ("demux", ["demux"] + [a for i, b in enumerate(DEMUX_BARCODES)
                           for a in ("--barcode", "s%d=%s" % (i, b.decode()))]
     + ["--mismatches", "1", "--out", "{out}/dm", "{in}"]),
    ("merge", ["merge", "--out", "{out}/m.fastq", "{r1}", "{r2}"]),
    ("tiles", ["tiles", "{in}"]),
)


def _cli_twin_check(name, files, oracle, text, out_dir):
    """The full-file run's totals against the host count and the oracle,
    and its output for the first TWIN_SAMPLE reads (or pairs) against the
    host twins."""
    import blazeseq_tpu_torch as bt
    from blazeseq_tpu_torch.ops import demux, merge, trim

    head = _head_records(files["align"], TWIN_SAMPLE)
    if name.startswith("stats"):
        bases = oracle["base_pp"].sum(1)
        gc = float(bases[1] + bases[2]) / (ALIGN_READS * READ_LEN)
        mq = float(np.sum(oracle["qual_hist"] * np.arange(64))) / (
            ALIGN_READS * READ_LEN)
        want = "reads=%d, bases=%d, errors=0, gc=%.4f, meanQ=%.2f" % (
            ALIGN_READS, ALIGN_READS * READ_LEN, gc, mq)
        if want not in text:
            raise AssertionError("cli %s: %r lacks %r" % (name, text, want))
    elif name.startswith("trim"):
        mode = name.split()[1]
        want_line = "reads %d -> kept" % ALIGN_READS
        if want_line not in text or "bases %d ->" % (
                ALIGN_READS * READ_LEN) not in text:
            raise AssertionError("cli %s: %r" % (name, text))
        expect = []
        for rid, s, q in head:
            if mode == "window":
                st, ln = 0, trim.sliding_window_trim_cpu(q, 33, 15, 4)
            elif mode == "bwa":
                st, ln = 0, trim.bwa_trim_cpu(q, 33, 20)
            else:
                st, ln = trim.clip_ends_cpu(q, 33, 3, 3)
            if ln > 0:
                expect.append((rid, s[st:st + ln], q[st:st + ln]))
        got = _head_records(os.path.join(out_dir, "t.fastq"), len(expect))
        if got != expect:
            raise AssertionError("cli %s: the first %d reads differ from the "
                                 "host twin" % (name, TWIN_SAMPLE))
    elif name == "demux":
        counts = [int(line.rsplit("\t", 1)[1]) for line in text.splitlines()]
        if sum(counts) != ALIGN_READS or len(counts) != 5:
            raise AssertionError("cli demux: %r" % text)
        a = demux.demux_assign_host([s for _, s, _ in head], DEMUX_BARCODES,
                                    1)
        for k, sample in enumerate(["s%d" % i for i in range(4)]
                                   + ["unassigned"]):
            want = [r for r, x in zip(head, a) if x == (k if k < 4 else -1)]
            got = _head_records(os.path.join(out_dir, "dm",
                                             sample + ".fastq"), len(want))
            if got != want:
                raise AssertionError("cli demux: %s differs from the host "
                                     "twin" % sample)
    elif name == "merge":
        if "pairs %d\t" % MATE_PAIRS not in text:
            raise AssertionError("cli merge: %r" % text)
        r1 = _head_records(files["r1"], TWIN_SAMPLE)
        r2 = _head_records(files["r2"], TWIN_SAMPLE)
        host = merge.merge_pairs_host([x[1:] for x in r1],
                                      [x[1:] for x in r2])
        want = [(a[0], s, q) for a, (o, s, q) in zip(r1, host) if o]
        got = _head_records(os.path.join(out_dir, "m.fastq"), len(want))
        if got != want:
            raise AssertionError("cli merge: the first pairs differ from "
                                 "the host twin")
    elif name == "tiles":
        cnt = oracle["tile_reads"].astype(np.float64)[:, None]
        mean = oracle["tile_pp"] / cnt
        dev = mean - oracle["tile_pp"].sum(0) / cnt.sum()
        want = ["%s\ttile %d\tmeanQ %.2f\tmax|dev| %.2f"
                % (files["align"], t, float(mean[k].mean()),
                   float(np.nanmax(np.abs(dev[k]))))
                for k, t in enumerate(TILES)]
        if text.splitlines() != want:
            raise AssertionError("cli tiles: %r, want %r" % (text, want))


# the records of a batch of each CLI command with a device op, and the
# wrapper whose launches it counts (one launch a batch)
CLI_BATCH_LAUNCHES = {"trim window": ("sliding_window_trim", 4096),
                      "trim bwa": ("bwa_trim", 4096),
                      "trim ends": ("clip_ends", 4096),
                      "demux": ("demux_assign", 16384),
                      "merge": ("merge_pairs", MERGE_BATCH),
                      "tiles": ("per_tile_qual_sums", 4096)}


def phase_cli(files, oracle, tmp, kernels):
    """python -m blazeseq_tpu_torch in-process with device="cuda": stats,
    stats --device, trim in three modes, demux --mismatches 1, merge and
    tiles on the 1M-read file (merge on MATE_PAIRS pairs), each checked
    against the host twins; then each on the 20,000-read (pair) prefix on
    the card and on the CPU, stdout and output files byte-equal. On the
    full file each command of CLI_BATCH_LAUNCHES makes one launch of its
    kernel a batch (a batch pair for merge)."""
    times = {}
    for name, argv in CLI_COMMANDS:
        full = os.path.join(tmp, "cli_full")
        args = [a.format(out=full, **{"in": files["align"], "r1": files["r1"],
                                      "r2": files["r2"]}) for a in argv]
        before = {k: f.launches for k, f in kernels.items()}
        text, _, wall = _cli(args, "cuda", full)
        _cli_twin_check(name, files, oracle, text, full)
        if name in CLI_BATCH_LAUNCHES:
            kernel, per = CLI_BATCH_LAUNCHES[name]
            reads = MATE_PAIRS if name == "merge" else ALIGN_READS
            got = kernels[kernel].launches - before[kernel]
            if got != -(-reads // per):
                raise AssertionError("cli %s: %d %s launches for %d batches"
                                     % (name, got, kernel, -(-reads // per)))
        shutil.rmtree(full)
        outs = {}
        for device in ("cuda", "cpu"):
            d = os.path.join(tmp, "cli_" + device)
            args = [a.format(out=d, **{"in": files["align_prefix"],
                                       "r1": files["r1_prefix"],
                                       "r2": files["r2_prefix"]})
                    for a in argv]
            outs[device] = _cli(args, device, d)
            shutil.rmtree(d)
        if outs["cuda"][:2] != outs["cpu"][:2]:
            raise AssertionError("cli %s: the prefix run on the card differs "
                                 "from the CPU's" % name)
        times[name] = wall
        log("cli %s: %.3f s on the full file; prefix: cuda == cpu (%d "
            "output files, cpu %.1f s)" % (name, wall, len(outs["cpu"][1]),
                                            outs["cpu"][2]))
    return times


# ------------------------------------------------------------- mesh paths

def _report_of(stats, width):
    """The QCReport that QCModel builds from these summed stats."""
    from blazeseq_tpu_torch import QCModel
    from blazeseq_tpu_torch.ops.stats import QCAccumulator

    acc = QCAccumulator()
    acc.add(stats)
    return QCModel(quality_schema="sanger", max_read_len=width,
                   device="cuda")._report_from_acc(acc)


def _stats_arrays(prefix, st):
    """{prefix.field: int64 array} of a QCStats (None leaves dropped)."""
    return {"%s.%s" % (prefix, k): np.asarray(v, np.int64)
            for k, v in zip(st._fields, st.to_numpy()) if v is not None}


def _stats_from(arrays, prefix):
    from blazeseq_tpu_torch.ops.stats import QCStats

    return QCStats(*(arrays.get("%s.%s" % (prefix, k))
                     for k in QCStats._fields))


def _same_arrays(got, want, label):
    """Every array of `want` equal in `got`; raises on the first that is
    not."""
    for k, v in want.items():
        if k not in got or not np.array_equal(got[k], v):
            raise AssertionError("%s: %s differs" % (label, k))


def phase_mesh_nccl(seed, files, keep, kernels):
    """A 1-rank NCCL mesh in this process: QCModel(mesh=...).run_file with
    the run_file(align_to) path's options on its 1M x 150 bp corpus, equal
    to that path's single-device report; build_uniform_qc_step(mesh) on a
    256 MiB uniform chunk, equal to the no-mesh step. The launches counted
    are those two drives'; the no-mesh twin and the timings after them are
    not counted."""
    import torch
    import torch.distributed as dist

    from blazeseq_tpu_torch import QCModel, parse_schema
    from blazeseq_tpu_torch.ops.stats import zero_stats
    from blazeseq_tpu_torch.ops.uniform_parse import detect_uniform_layout
    from blazeseq_tpu_torch.parallel import (build_uniform_qc_step,
                                             make_mesh, shard_batch)
    from blazeseq_tpu_torch.parallel.mesh import DP_AXIS, psum_tuple

    mesh = make_mesh(1)
    try:
        backend = dist.get_backend()
        # NCCL sets its communicator up on the first collective: once a
        # process, outside the timed runs
        st = type(zero_stats(1))(*(v if v is None else v.cuda()
                                   for v in zero_stats(QC_WIDTH)))
        t0 = time.perf_counter()
        psum_tuple(mesh, st, (DP_AXIS,))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        # the merge a mesh step makes: one flat all-reduce of every stats
        # leaf; beside it, torch's bare all-reduce of a buffer of that size
        t0 = time.perf_counter()
        for _ in range(100):
            psum_tuple(mesh, st, (DP_AXIS,))
        torch.cuda.synchronize()
        merge_ms = (time.perf_counter() - t0) * 10
        flat = torch.cat([v.reshape(-1) for v in st if v is not None])
        t0 = time.perf_counter()
        for _ in range(100):
            dist.all_reduce(flat)
        torch.cuda.synchronize()
        bare_ms = (time.perf_counter() - t0) * 10
        model = QCModel(device="cuda", mesh=mesh, **_align_kw(seed))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = model.run_file(files["align"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        _same_reports(rep, keep["align_report"],
                      "QCModel(mesh, 1 rank).run_file vs one device")
        n = (256 << 20) // RS
        rec, _ = _make_block(seed, 10 ** 6, 0, n, False)
        lay = detect_uniform_layout(rec)
        sanger = parse_schema("sanger")
        step = build_uniform_qc_step(mesh, lay, sanger, width=QC_WIDTH)
        (chunk,) = shard_batch(mesh, rec)
        got = step(chunk, rec.size)
        torch.cuda.synchronize()
        counted = {k: f.launches for k, f in kernels.items()}
        single = build_uniform_qc_step(None, lay, sanger, width=QC_WIDTH)
        want = single(chunk, rec.size)
        max_abs_diff((*got[:3], *got[3]), (*want[:3], *want[3]),
                     "build_uniform_qc_step(mesh, 1 rank) vs no mesh")
        if not bool(got[2]) or int(got[0]) != n:
            raise AssertionError("build_uniform_qc_step(mesh): ok=%s, %d "
                                 "records" % (bool(got[2]), int(got[0])))
        ms = cuda_ms(lambda: step(chunk, rec.size), inner=3)
        single_ms = cuda_ms(lambda: single(chunk, rec.size), inner=3)
    finally:
        dist.destroy_process_group()
    for k, f in kernels.items():
        f.launches = counted[k]
    out = dict(backend=backend, first_collective_s=init_s,
               stats_merge_ms=merge_ms, bare_all_reduce_ms=bare_ms,
               run_file_wall_s=wall,
               run_file_reads_per_s=ALIGN_READS / wall,
               single_wall_s=keep["align_wall_s"],
               single_reads_per_s=ALIGN_READS / keep["align_wall_s"],
               uniform_step_ms=ms, uniform_single_ms=single_ms,
               uniform_gbps=rec.size / ms / 1e6)
    log("mesh (%s, 1 rank, in this process): first collective %.3f s, "
        "the stats merge %.4f ms a call (host wall of 100, then a sync; "
        "torch's bare all-reduce of that buffer %.4f ms); "
        "QCModel(mesh).run_file(align_to,"
        " adapters, duplicates, quartiles) %d reads in %.3f s, %.0f reads/s "
        "(one device %.3f s, %.0f reads/s), report equal; "
        "build_uniform_qc_step(mesh) on a 256 MiB chunk %.3f ms, %.1f GB/s "
        "(no mesh %.3f ms), equal" % (
            backend, init_s, merge_ms, bare_ms, ALIGN_READS, wall,
            out["run_file_reads_per_s"],
            out["single_wall_s"], out["single_reads_per_s"], ms,
            out["uniform_gbps"], single_ms))
    return out


def _spawn(case, world, tmp, inputs):
    """Run mesh_worker's `case` on `world` ranks, each a process of its own
    on cuda:0 in one gloo group (NCCL takes one rank a card), through the
    tests' launcher (tests/torch_dist_worker.launch: torchrun's variables,
    a file store, every rank killed after MESH_TIMEOUT seconds). Returns
    each rank's arrays and its meta (wall time, launch counts), in rank
    order, and the wall time from the first start to the last exit."""
    from tests.torch_dist_worker import launch

    t0 = time.perf_counter()
    ranks = launch(case, world, tmp, inputs, timeout=MESH_TIMEOUT,
                   command=[sys.executable, os.path.abspath(__file__),
                            "--mesh-worker"])
    wall = time.perf_counter() - t0
    return [(a, json.loads(str(a.pop("meta")))) for a in ranks], wall


def _mesh_multihost(x):
    from blazeseq_tpu_torch.parallel import run_multihost_qc

    stats, reads, bases = run_multihost_qc(
        str(x["path"]), reference=NW_REFERENCE, device="cuda:0")
    out = _stats_arrays("qc", stats["qc"])
    out.update(nw_sum=stats["nw_sum"], nw_count=stats["nw_count"],
               local_reads=np.int64(reads), local_bases=np.int64(bases))
    return out


def _mesh_dpsp(x):
    import torch

    from blazeseq_tpu_torch import parse_schema
    from blazeseq_tpu_torch.parallel import build_qc_align_step, shard_batch
    from blazeseq_tpu_torch.parallel.mesh import (gather_rows, make_mesh_2d,
                                                  replicated)

    mesh = make_mesh_2d(2, 2, device="cuda:0", backend="gloo")
    seq, qual, lengths = shard_batch(mesh, x["seq"], x["qual"], x["lengths"])
    res = build_qc_align_step(mesh, with_alignment=True)(
        seq, qual, lengths, int(x["n_records"]), parse_schema("sanger"),
        replicated(mesh).local(x["ref"]))
    torch.cuda.synchronize()
    out = _stats_arrays("stats", res.stats)
    for k in ("error_codes", "phred", "nw_scores"):
        out[k] = gather_rows(mesh, getattr(res, k)).cpu().numpy()
    return out


def _mesh_ragged(x):
    """This rank's shard of each 512 MiB span through the 2-rank ragged
    step; the good shards' stats summed over the spans."""
    import torch
    import torch.distributed as dist

    from blazeseq_tpu_torch import parse_schema
    from blazeseq_tpu_torch.parallel import build_ragged_qc_step, make_mesh

    mesh = make_mesh(2, device="cuda:0", backend="gloo")
    rank = dist.get_rank()
    step = build_ragged_qc_step(mesh, parse_schema("sanger"),
                                width=QC_WIDTH)
    spans = x["spans"]  # int64 [n_spans, ranks, 2]: byte ranges
    chunk = torch.zeros(int(x["shard_bytes"]), dtype=torch.uint8,
                        device="cuda:0")
    total = None
    with open(str(x["path"]), "rb") as f:
        for span in spans:
            lo, hi = (int(v) for v in span[rank])
            f.seek(lo)
            data = np.frombuffer(f.read(hi - lo), np.uint8)
            chunk[:hi - lo].copy_(torch.from_numpy(data))
            chunk[hi - lo:].zero_()
            n_valid = torch.tensor([hi - lo], dtype=torch.int32,
                                   device="cuda:0")
            good, fb, tail, st = step(chunk, n_valid)
            want = [int(b - a) for a, b in span]
            if (not bool(good.all()) or bool(fb.any())
                    or tail.tolist() != want):
                raise AssertionError("span %s: good %s, fallback %s, tail "
                                     "%s" % (span.tolist(), good.tolist(),
                                             fb.tolist(), tail.tolist()))
            st = st.to_numpy()
            total = st if total is None else st.merge(total)
    return _stats_arrays("stats", total)


MESH_CASES = dict(multihost=_mesh_multihost, dpsp=_mesh_dpsp,
                  ragged=_mesh_ragged)


def mesh_worker(case, store, inp, out):
    """One rank of a spawned mesh job (see _spawn): joins the gloo group
    from torchrun's variables and the file store, sets the launch counts
    to 0, runs MESH_CASES[case] between two barriers and writes its arrays
    with the wall time and the counts."""
    import torch
    import torch.distributed as dist

    from blazeseq_tpu_torch.parallel import init_distributed

    from blazeseq_tpu_torch import _kernels

    kernels = _kernel_fns()
    init_distributed("file://" + store, device="cuda:0", backend="gloo")
    try:
        with np.load(inp) as f:
            x = dict(f)
        # the process's one-time costs (the CUDA context, the kernels'
        # library) come before the timed window
        torch.zeros(1, device="cuda:0")
        _kernels.load()
        for k in kernels.values():
            k.launches = 0
        restore = _no_plain_on_card()
        dist.barrier()
        t0 = time.perf_counter()
        try:
            res = MESH_CASES[case](x)
            torch.cuda.synchronize()
        finally:
            restore()
        dist.barrier()
        meta = dict(wall_s=time.perf_counter() - t0,
                    backend=dist.get_backend(),
                    launches={k: f.launches for k, f in kernels.items()})
        np.savez("%s.%d.npz" % (out, dist.get_rank()),
                 meta=np.array(json.dumps(meta)), **res)
    finally:
        dist.destroy_process_group()


def _ragged_spans(path, size):
    """Byte ranges [span][rank] of the 2-rank ragged job: spans of at most
    MESH_SPAN bytes, each cut in two at a record boundary, every shard at
    most MESH_SPAN / 2 bytes and ending at a record boundary."""
    from blazeseq_tpu_torch.parallel import find_record_boundary

    spans, lo = [], 0
    while lo < size:
        # a record is under 2 KiB: the next boundary after a cut point
        # lies within 2 KiB of it
        hi = (size if size - lo <= MESH_SPAN - 4096
              else find_record_boundary(path, lo + MESH_SPAN - 4096))
        mid = find_record_boundary(path, lo + (hi - lo) // 2)
        spans.append([[lo, mid], [mid, hi]])
        lo = hi
    arr = np.array(spans, np.int64)
    if (arr[:, :, 1] - arr[:, :, 0]).max() > MESH_SPAN // 2:
        raise AssertionError("a ragged shard exceeds %d bytes"
                             % (MESH_SPAN // 2))
    return arr


def phase_mesh_ranks(seed, files, oracle, keep, ragged, tmp, kernels):
    """Ranks spawned as processes of their own, all on cuda:0 in gloo
    groups: run_multihost_qc on 2 ranks over the 1M x 150 bp corpus with a
    40 bp reference, against one process and the numpy oracle, its shards
    disjoint and covering the file; build_qc_align_step on a 2 x 2 mesh
    (4 ranks) over a 32,768 x 256 padded batch with alignment, against
    the no-mesh step; build_ragged_qc_step on 2 ranks over the 1 GiB
    ragged corpus in 512 MiB spans, summed, against run_file_device's
    report on that file. The single-process twins run first and their
    launches are not counted; the ranks' launches are."""
    import torch

    from blazeseq_tpu_torch import parse_schema
    from blazeseq_tpu_torch.parallel import (build_qc_align_step,
                                             run_multihost_qc)

    # the single-process twins
    t0 = time.perf_counter()
    one, reads, bases = run_multihost_qc(files["align"],
                                         reference=NW_REFERENCE,
                                         device="cuda")
    torch.cuda.synchronize()
    one_wall = time.perf_counter() - t0
    check_report(_report_of(one["qc"], 256), oracle, 256)
    rng = np.random.default_rng([seed, 41])
    seq, qual, lengths = kernel_a_inputs(rng, MESH_BATCH, MESH_WIDTH)
    x = dict(seq=seq, qual=qual, lengths=lengths,
             n_records=np.int64(MESH_BATCH - 3),
             ref=np.frombuffer(NW_REFERENCE, np.uint8).copy())
    res = build_qc_align_step(with_alignment=True)(
        *(torch.from_numpy(a).cuda() for a in (seq, qual, lengths)),
        MESH_BATCH - 3, parse_schema("sanger"),
        torch.from_numpy(x["ref"]).cuda())
    dpsp_want = _stats_arrays("stats", res.stats)
    for k in ("error_codes", "phred", "nw_scores"):
        dpsp_want[k] = getattr(res, k).cpu().numpy()
    path = ragged[0]
    spans = _ragged_spans(path, os.path.getsize(path))
    for k in kernels.values():
        k.launches = 0

    jobs = {}
    jobs["multihost"] = _spawn("multihost", 2, tmp, dict(
        path=np.array(files["align"])))
    jobs["dpsp"] = _spawn("dpsp", 4, tmp, x)
    jobs["ragged"] = _spawn("ragged", 2, tmp, dict(
        path=np.array(path), spans=spans,
        shard_bytes=np.int64(MESH_SPAN // 2)))

    want = _stats_arrays("qc", one["qc"])
    want.update(nw_sum=one["nw_sum"], nw_count=one["nw_count"])
    ranks, _ = jobs["multihost"]
    for r, (arrays, _) in enumerate(ranks):
        _same_arrays(arrays, want, "run_multihost_qc rank %d vs one process"
                     % r)
    local = [int(a["local_reads"]) for a, _ in ranks]
    if sum(local) != ALIGN_READS or min(local) == 0 or sum(
            int(a["local_bases"]) for a, _ in ranks) != bases:
        raise AssertionError("run_multihost_qc: local reads %s" % local)
    for r, (arrays, _) in enumerate(jobs["dpsp"][0]):
        _same_arrays(arrays, dpsp_want, "2 x 2 mesh rank %d vs no mesh" % r)
    ragged_want = keep["ragged_device"]["report"]
    for r, (arrays, _) in enumerate(jobs["ragged"][0]):
        _same_reports(_report_of(_stats_from(arrays, "stats"), QC_WIDTH),
                      ragged_want, "ragged step, 2 ranks, rank %d vs "
                      "run_file_device" % r)

    rank_launches = dict.fromkeys(kernels, 0)
    out = dict(rank_launches=rank_launches)
    for name, (ranks, wall) in jobs.items():
        metas = [m for _, m in ranks]
        for m in metas:
            for k, v in m["launches"].items():
                rank_launches[k] += v
        out[name] = dict(ranks=len(ranks), backend=metas[0]["backend"],
                         wall_s=max(m["wall_s"] for m in metas),
                         spawn_wall_s=wall,
                         launches=[m["launches"] for m in metas])
    mh, dp, rg = out["multihost"], out["dpsp"], out["ragged"]
    mh.update(reads_per_s=ALIGN_READS / mh["wall_s"], single_wall_s=one_wall,
              single_reads_per_s=ALIGN_READS / one_wall)
    dp.update(reads_per_s=MESH_BATCH / dp["wall_s"])
    size = int(spans[-1, -1, 1])
    rg.update(bytes=size, spans=len(spans), gbps=size / rg["wall_s"] / 1e9,
              single_wall_s=keep["ragged_device"]["wall_s"],
              single_gbps=size / keep["ragged_device"]["wall_s"] / 1e9)
    log("mesh (gloo, ranks on one card): run_multihost_qc 2 ranks %.3f s "
        "in the ranks (%.1f s with their start), %.0f reads/s (one process "
        "%.3f s, %.0f reads/s), merged stats equal, shards %s; 2 x 2 "
        "build_qc_align_step on %d x %d %.3f s (%.1f s with the start), "
        "equal to no mesh; ragged step 2 ranks on %d bytes in %d spans "
        "%.3f s (%.1f s with the start), %.3f GB/s (run_file_device %.3f "
        "s, %.3f GB/s), report equal" % (
            mh["wall_s"], mh["spawn_wall_s"], mh["reads_per_s"], one_wall,
            mh["single_reads_per_s"], local, MESH_BATCH, MESH_WIDTH,
            dp["wall_s"], dp["spawn_wall_s"], size, len(spans),
            rg["wall_s"], rg["spawn_wall_s"], rg["gbps"],
            rg["single_wall_s"], rg["single_gbps"]))
    return out


def _no_plain_on_card():
    """Wrap the plain torch versions of the kernels that the host route's
    steps, the device-parse API and the CLI's ops dispatch to (ops/nw.py's
    wavefronts, qc_stats_torch, adapter_content_torch, read_hashes_torch,
    raw_stream_qc_torch, newline_positions_torch, record_offsets_torch,
    gather_padded_torch, count_records_torch, merge_pairs_torch, the three
    trim modes' *_torch, demux_assign_torch, per_tile_qual_sums_torch and
    kmer_counts_torch) so that a call with a CUDA tensor among its
    positional arguments raises; returns a function that unwraps them.
    The plain branches of read_hashes and of _read_hashes_into (the
    duplication sample) both call read_hashes_torch by the module's name,
    so both are covered."""
    from blazeseq_tpu_torch.ops import (adapter, dedup, demux, kmer, merge, nw,
                                        raw_stats, scan, stats, tiles, trim)

    saved = [(nw, n) for n in ["nw_scores_torch"] + [
        plain for _, plain, _ in nw.VARIANT_MODES.values()]]
    saved += [(stats, "qc_stats_torch"), (adapter, "adapter_content_torch"),
              (dedup, "read_hashes_torch"),
              (raw_stats, "raw_stream_qc_torch"),
              (merge, "merge_pairs_torch"), (demux, "demux_assign_torch"),
              (tiles, "per_tile_qual_sums_torch"),
              (kmer, "kmer_counts_torch")]
    saved += [(trim, n + "_torch") for n in ("clip_ends",
                                             "sliding_window_trim",
                                             "bwa_trim")]
    saved += [(scan, n) for n in ("newline_positions_torch",
                                  "record_offsets_torch",
                                  "gather_padded_torch",
                                  "count_records_torch")]
    saved = [(mod, n, getattr(mod, n)) for mod, n in saved]

    def guard(name, fn):
        def wrapped(*a, **k):
            if any(getattr(x, "is_cuda", False) for x in a):
                raise AssertionError("%s, a plain torch version, ran on the "
                                     "card" % name)
            return fn(*a, **k)
        return wrapped

    for mod, name, fn in saved:
        setattr(mod, name, guard(name, fn))
    return lambda: [setattr(mod, n, fn) for mod, n, fn in saved]


def run_path(name, fn, kernels):
    """Drive one path with every launch count set to 0 just before it, and
    no plain torch version of a host-route kernel allowed on the card;
    returns its result and the counts read just after. Raises when a
    kernel of the path was never launched."""
    import torch

    for k in kernels.values():
        k.launches = 0
    restore = _no_plain_on_card()
    t0 = time.perf_counter()
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        restore()
    wall = time.perf_counter() - t0
    got = {name_: k.launches for name_, k in kernels.items()}
    # a path whose ranks ran in processes of their own adds their counts
    ranks = out.pop("rank_launches", {}) if isinstance(out, dict) else {}
    for k, v in ranks.items():
        got[k] += v
    log("launches on the %s path: %s; the path took %.1f s"
        % (name, got, wall))
    return out, got


def _kernel_fns():
    """The wrapper of every kernel, by name; each counts its launches."""
    from blazeseq_tpu_torch.ops.adapter import adapter_content
    from blazeseq_tpu_torch.ops.dedup import read_hashes
    from blazeseq_tpu_torch.ops.demux import demux_assign
    from blazeseq_tpu_torch.ops.kmer import kmer_counts
    from blazeseq_tpu_torch.ops.merge import merge_pairs
    from blazeseq_tpu_torch.ops.nw import nw_scores, nw_variant_scores
    from blazeseq_tpu_torch.ops.ragged_qc import ragged_qc
    from blazeseq_tpu_torch.ops.raw_stats import raw_stream_qc
    from blazeseq_tpu_torch.ops.scan import (count_records_device,
                                             gather_padded_device,
                                             newline_positions_device,
                                             record_offsets_device,
                                             structural_bitmaps)
    from blazeseq_tpu_torch.ops.stats import qc_stats
    from blazeseq_tpu_torch.ops.tiles import per_tile_qual_sums
    from blazeseq_tpu_torch.ops.trim import (bwa_trim, clip_ends,
                                             sliding_window_trim)
    from blazeseq_tpu_torch.ops.uniform_qc import uniform_qc
    from blazeseq_tpu_torch.ops.validate import validate_decode

    return dict(uniform_qc=uniform_qc, validate_decode=validate_decode,
                nw_scores=nw_scores, nw_variant_scores=nw_variant_scores,
                structural_bitmaps=structural_bitmaps,
                ragged_qc=ragged_qc, qc_stats=qc_stats,
                adapter_content=adapter_content, read_hashes=read_hashes,
                raw_stream_qc=raw_stream_qc,
                newline_positions=newline_positions_device,
                record_offsets=record_offsets_device,
                gather_padded=gather_padded_device,
                count_records=count_records_device, merge_pairs=merge_pairs,
                clip_ends=clip_ends, sliding_window_trim=sliding_window_trim,
                bwa_trim=bwa_trim, demux_assign=demux_assign,
                per_tile_qual_sums=per_tile_qual_sums,
                kmer_counts=kmer_counts)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    # one rank of a mesh path, which this script spawns (see _spawn)
    ap.add_argument("--mesh-worker", nargs=4,
                    metavar=("CASE", "STORE", "INPUT", "OUTPUT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch

    if args.mesh_worker:
        return mesh_worker(*args.mesh_worker)
    t_start = time.perf_counter()
    name, smi = phase_card()
    kernels = _kernel_fns()
    phase_build()
    torch.cuda.synchronize()
    ka = phase_kernel_a(args.seed)
    torch.cuda.synchronize()
    kb = phase_kernel_b(args.seed)
    torch.cuda.synchronize()
    knw, nw_times = phase_kernel_nw(args.seed)
    torch.cuda.synchronize()
    kvar, var_times = phase_kernel_nw_variants(args.seed)
    torch.cuda.synchronize()
    kscan = phase_kernel_scan(args.seed)
    torch.cuda.synchronize()
    kpanels = phase_padded_panels(args.seed)
    torch.cuda.synchronize()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    align = {}

    def ragged():
        # written just before its first path, after the uniform one
        if "ragged" not in align:
            align["ragged"] = make_ragged_corpus(args.seed, tmp)
        return align["ragged"]

    # each path: (name, phase, the kernels it must launch)
    paths = [
        ("run_file_device", lambda: phase_main_path(args.seed, tmp),
         ("uniform_qc",)),
        ("run_file_device(semi)", lambda: phase_semi(args.seed, tmp),
         ("uniform_qc",)),
        ("run_file_device(gzip)", lambda: phase_gzip(args.seed, tmp),
         ("uniform_qc",)),
        ("run_file_device(ragged)", lambda: phase_ragged(ragged(), align),
         ("ragged_qc",)),
        ("run_file_device(bgzf ragged)",
         lambda: phase_bgzf_ragged(ragged(), tmp), ("ragged_qc",)),
        ("fallback", lambda: phase_fallback(args.seed, tmp),
         ("validate_decode", "qc_stats")),
        ("NWAligner", phase_aligner, ("nw_scores",)),
        ("NWAligner(variants)", phase_aligner_variants,
         ("nw_variant_scores",)),
        ("run_file(align_to)",
         lambda: phase_align_run_file(args.seed, *align["corpus"], align),
         ("validate_decode", "qc_stats", "nw_scores", "adapter_content",
          "read_hashes")),
        ("device_parse",
         lambda: phase_device_parse(args.seed, ragged()),
         ("structural_bitmaps", "raw_stream_qc", "newline_positions",
          "record_offsets", "gather_padded", "count_records")),
        ("cli", lambda: phase_cli(*align["corpus"], tmp, kernels),
         ("uniform_qc", "validate_decode", "qc_stats", "merge_pairs",
          "clip_ends", "sliding_window_trim", "bwa_trim", "demux_assign",
          "per_tile_qual_sums")),
        ("analysis", lambda: phase_analysis(align["corpus"][0]),
         ("bwa_trim", "kmer_counts")),
        ("mesh(nccl, 1 rank)",
         lambda: phase_mesh_nccl(args.seed, align["corpus"][0], align,
                                 kernels),
         ("validate_decode", "qc_stats", "nw_scores", "adapter_content",
          "read_hashes", "uniform_qc")),
        ("mesh(gloo, ranks on one card)",
         lambda: phase_mesh_ranks(args.seed, *align["corpus"], align,
                                  ragged(), tmp, kernels),
         ("validate_decode", "qc_stats", "nw_scores", "ragged_qc")),
    ]
    e2e = {}
    launches = dict.fromkeys(kernels, 0)
    try:
        kragged, kragged_notes = phase_kernel_ragged(args.seed, tmp)
        torch.cuda.synchronize()
        kparse, kparse_notes = phase_kernel_device_parse(args.seed, tmp)
        torch.cuda.synchronize()
        align["corpus"] = make_align_corpus(args.seed, tmp)
        kmerge = phase_kernel_merge(args.seed, align["corpus"][0])
        torch.cuda.synchronize()
        kcli = phase_kernel_cli_ops(args.seed, align["corpus"][0])
        torch.cuda.synchronize()
        for path_name, fn, needed in paths:
            e2e[path_name], got = run_path(path_name, fn, kernels)
            for k in needed:
                if got[k] == 0:
                    raise AssertionError("kernel %s was never launched on "
                                         "the %s path" % (k, path_name))
            one_pass = {"run_file_device(gzip)": "uniform_qc",
                        "run_file_device(ragged)": "ragged_qc",
                        "run_file_device(bgzf ragged)": "ragged_qc"}
            if (path_name in one_pass and got[one_pass[path_name]]
                    != e2e[path_name]["chunks"]):
                # the ragged and stream tiers take full-bin histograms: one
                # pass, one launch a chunk
                raise AssertionError(
                    "%d %s launches for %d chunks on the %s path"
                    % (got[one_pass[path_name]], one_pass[path_name],
                       e2e[path_name]["chunks"], path_name))
            for k, v in got.items():
                launches[k] += v
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log("launches on the paths, summed:", launches)
    log("NW kernel timings:", json.dumps(nw_times))
    log("variant kernel timings:", json.dumps(var_times))
    log("ragged kernels: %.4f ms a call;" % kragged["ms"],
        json.dumps(kragged_notes))
    log("device-parse kernels:", json.dumps(kparse_notes))
    log("end to end:", json.dumps(e2e))
    log("total %.1f s" % (time.perf_counter() - t_start))
    # one PyTorch call computes the tile sums (torch.mm of the one-hot tile
    # matrix, as the reference's einsum: tiles_library_call), timed in the
    # CLI ops' phase; no single PyTorch call computes any of the other
    # eighteen functions, so they have no library time. Kernel A has one
    # record per shape of
    # KERNEL_A_SHAPES. The ragged, the alignment variant and the three
    # padded-batch panel kernels replace XLA code (no Pallas kernel): their
    # `replaces` name the reference's ragged_qc, its five XLA alignment
    # variants, qc_stats, adapter_content and read_hashes. The variant
    # kernel's ms, plain_ms and bound are its five modes' calls together at
    # the example's shape, each mode's under `modes`. The device-parse
    # kernels replace XLA code of the reference's raw_stats.py and scan.py,
    # and the merge kernel the reference's merge_pairs (XLA: a lax.scan).
    # The CLI ops' four kernels replace the reference's XLA code of trim.py
    # (three modes: their calls together at 4,096 x 256, each mode under
    # `modes`), demux.py, tiles.py and kmer.py; each holds its records at
    # both timed shapes
    print(json.dumps({"kernels": [
        dict(name="uniform_qc", route="cuda", source=KERNEL_B_SOURCE,
             replaces="blazeseq_tpu/ops/fused_qc.py:205",
             launches=launches["uniform_qc"], library_ms=None, **kb),
        *(dict(name="validate_decode", route="cuda", source=KERNEL_A_SOURCE,
               replaces="blazeseq_tpu/ops/validate.py:94",
               launches=launches["validate_decode"], library_ms=None, **rec)
          for rec in ka),
        dict(name="nw_scores", route="cuda", source=KERNEL_NW_SOURCE,
             replaces="blazeseq_tpu/ops/nw.py:174",
             launches=launches["nw_scores"], library_ms=None, **knw),
        dict(name="nw_variants", route="cuda", source=KERNEL_NW_SOURCE,
             replaces="blazeseq_tpu/ops/nw.py:240-566",
             launches=launches["nw_variant_scores"], library_ms=None,
             modes=var_times, **kvar),
        dict(name="structural_bitmaps", route="cuda",
             source=KERNEL_SCAN_SOURCE,
             replaces="blazeseq_tpu/ops/scan.py:78",
             launches=launches["structural_bitmaps"], library_ms=None,
             **kscan),
        dict(name="ragged_qc", route="cuda", source=KERNEL_RAGGED_SOURCE,
             replaces="blazeseq_tpu/ops/ragged_qc.py:182",
             launches=launches["ragged_qc"], library_ms=None, **kragged),
        dict(name="qc_stats", route="cuda", source=KERNEL_QC_STATS_SOURCE,
             replaces="blazeseq_tpu/ops/stats.py:150-241",
             launches=launches["qc_stats"], library_ms=None,
             **kpanels["qc_stats"]),
        dict(name="adapter_content", route="cuda",
             source=KERNEL_ADAPTER_SOURCE,
             replaces="blazeseq_tpu/ops/adapter.py:62-83",
             launches=launches["adapter_content"], library_ms=None,
             **kpanels["adapter_content"]),
        dict(name="read_hashes", route="cuda", source=KERNEL_HASH_SOURCE,
             replaces="blazeseq_tpu/ops/dedup.py:41-62",
             launches=launches["read_hashes"], library_ms=None,
             **kpanels["read_hashes"]),
        *(dict(name=name, route="cuda", source=KERNEL_PARSE_SOURCE,
               replaces=replaces, launches=launches[name], library_ms=None,
               **kparse[name]) for name, replaces in PARSE_KERNELS),
        dict(name="merge_pairs", route="cuda", source=KERNEL_MERGE_SOURCE,
             replaces="blazeseq_tpu/ops/merge.py:59-146",
             launches=launches["merge_pairs"], library_ms=None, **kmerge),
        dict(name="trim", route="cuda", source=KERNEL_TRIM_SOURCE,
             replaces="blazeseq_tpu/ops/trim.py:43-62,76-95,106-126",
             launches=sum(launches[k] for k in ("sliding_window_trim",
                                                "bwa_trim", "clip_ends")),
             launches_by_mode={k: launches[k] for k in (
                 "sliding_window_trim", "bwa_trim", "clip_ends")},
             library_ms=None, **kcli["trim"]),
        dict(name="demux_assign", route="cuda", source=KERNEL_DEMUX_SOURCE,
             replaces="blazeseq_tpu/ops/demux.py:38-54",
             launches=launches["demux_assign"], library_ms=None,
             **kcli["demux_assign"]),
        dict(name="per_tile_qual_sums", route="cuda",
             source=KERNEL_TILES_SOURCE,
             replaces="blazeseq_tpu/ops/tiles.py:50-56,59-95",
             launches=launches["per_tile_qual_sums"],
             **kcli["per_tile_qual_sums"]),
        dict(name="kmer_counts", route="cuda", source=KERNEL_KMER_SOURCE,
             replaces="blazeseq_tpu/ops/kmer.py:30-63",
             launches=launches["kmer_counts"], library_ms=None,
             **kcli["kmer_counts"]),
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
