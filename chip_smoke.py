"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--seed N]

Builds the port's CUDA kernels from blazeseq_tpu_torch/csrc (one nvcc per
source, all started together), holds each kernel against its plain torch
version on the card, then drives the port's paths, each with the launch
counts set to 0 just before it and read just after:

* QCModel(device="cuda").run_file_device over a 2 GiB uniform FASTQ file
  and a 1 GiB quality-binned one, each checked panel by panel against an
  independent numpy oracle;
* its fallback route (a mid-file quality error and a trailing partial
  record) against the same call on the CPU;
* NWAligner on 1M reads x 40 bp against a 40 bp reference in batches of
  65,536, the first 2,000 scores against the numpy twin;
* QCModel(align_to=..., adapters, duplicates, quartiles).run_file on 1M
  reads x 150 bp: core panels against the oracle, 2,000 alignment scores
  against the numpy twin, and every panel of a 20,000-read prefix against
  the same call on the CPU;
* the device-parse API (raw_stream_qc, count_records_device,
  parse_fastq_device) over a 1 GiB ragged FASTQ in 256 MiB chunks, against
  the host parser and the generator;
* the command line (python -m blazeseq_tpu_torch: stats, stats --device,
  trim in three modes, demux, merge, tiles) in-process on the card over
  the 1M-read file and 250,000 read pairs, against the host twins, and on
  20,000-read prefixes against the same commands on the CPU.

Every phase raises on failure. The second-to-last lines are the kernels'
JSON record and the card's name and power limit; the last line is the
device JSON. Needs a CUDA card: without one it exits nonzero and prints no
result.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

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
# merge: 250,000 pairs from 200 bp fragments, R1 = the first 150 bp, R2 =
# the reverse complement of the last 150
MATE_PAIRS = 250_000
FRAG_LEN = 200
MATE_HEADER = b"@P0000000/1"
_COMP_LUT = np.frombuffer(b"TGCA", np.uint8)  # complement of draws 0..3


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


def write_ragged_corpus(path, target_bytes, seed):
    """Write records of RAGGED_LEN read lengths and RAGGED_ID id widths up
    to `target_bytes` (threads fill blocks of records and pwrite them).
    Returns the oracle totals and every record's start offset."""
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
        seq_pos = (st[rec] + il[rec] + 2 + np.arange(len(rec))
                   - np.repeat(_exclusive_cumsum(rl), rl))
        buf[seq_pos] = _SEQ_LUT[draw]
        buf[seq_pos + rl[rec] + 3] = phred + 33
        del rec, seq_pos
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
        return (np.bincount(_CLASS_LUT[draw], minlength=5),
                np.bincount(phred, minlength=64))

    try:
        with cf.ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as ex:
            parts = list(ex.map(job, range(-(-n // block))))
    finally:
        os.close(fd)
    oracle = dict(reads=n, bases=int(read_len.sum()),
                  bytes=int(size.sum()),
                  base_counts=sum(p[0] for p in parts),
                  qual_hist=sum(p[1] for p in parts))
    return oracle, np.append(starts, oracle["bytes"])


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


def check_report(rep, oracle, width):
    """Every report panel against the oracle; raises on the first
    mismatch."""
    n = oracle["reads"]
    L = READ_LEN
    base_pp = np.zeros((5, width), np.int64)
    base_pp[:, :L] = oracle["base_pp"]
    count = np.zeros(width, np.int64)
    count[:L] = n
    qual_pp = np.zeros(width, np.int64)
    qual_pp[:L] = oracle["qual_pp"]
    length_hist = np.zeros(512, np.int64)
    length_hist[L] = n
    base_counts = base_pp.sum(1)
    bases = n * L
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
    from blazeseq_tpu_torch import _kernels

    t0 = time.perf_counter()
    _kernels.load()
    log("build + load of %s: %.2f s" % (", ".join(_kernels.SOURCES),
                                        time.perf_counter() - t0))


def phase_kernel_a(seed):
    """Kernel A (validate) against its plain version on the card."""
    import torch

    from blazeseq_tpu.fastq.quality import parse_schema
    from blazeseq_tpu_torch.ops.validate import (validate_decode,
                                                 validate_decode_torch)

    rng = np.random.default_rng([seed, 1])
    schema = parse_schema("sanger")
    err = 0
    n_cases = 0
    for L in (256, 384):
        n = 4096
        seq = _SEQ_LUT[rng.integers(0, 256, (n, L))].copy()
        qual = rng.integers(33, 75, (n, L)).astype(np.uint8)
        # high bits, out-of-range (and wrapping) quality bytes
        seq[rng.integers(0, n, 40), rng.integers(0, L, 40)] |= 0x80
        qual[rng.integers(0, n, 40), rng.integers(0, L, 40)] |= 0x80
        qual[rng.integers(0, n, 80), rng.integers(0, L, 80)] = 20
        qual[rng.integers(0, n, 80), rng.integers(0, L, 80)] = 100
        lengths = rng.integers(0, L + 64, n).astype(np.int32)
        lengths[:16] = 0
        lengths[16:32] = L + 500
        dseq, dqual, dlen = (torch.from_numpy(a).cuda()
                             for a in (seq, qual, lengths))
        for col_offset in (0, 128):
            for ca, cq in ((True, True), (True, False), (False, True)):
                kw = dict(check_ascii=ca, check_quality=cq,
                          col_offset=col_offset)
                got = validate_decode(dseq, dqual, dlen, schema, **kw)
                want = validate_decode_torch(
                    dseq, dqual, dlen, schema.LOWER, schema.UPPER,
                    schema.OFFSET, **kw)
                torch.cuda.synchronize()
                err = max(err, max_abs_diff(got, want, "kernel A, L=%d %r"
                                            % (L, kw)))
                n_cases += 1
        if L == 256:
            ms = cuda_ms(lambda: validate_decode(dseq, dqual, dlen, schema))
            plain_ms = cuda_ms(lambda: validate_decode_torch(
                dseq, dqual, dlen, schema.LOWER, schema.UPPER,
                schema.OFFSET))
    log("kernel A == plain on %d cases; [4096, 256]: kernel %.4f ms, "
        "plain %.4f ms" % (n_cases, ms, plain_ms))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


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

    from blazeseq_tpu.fastq.quality import parse_schema
    from blazeseq_tpu_torch.ops.uniform_parse import detect_uniform_layout
    from blazeseq_tpu_torch.ops.uniform_qc import (uniform_qc,
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

    # time one full-size chunk of the main path's layout
    n = (256 << 20) // RS
    rec, _ = _make_block(seed, 10 ** 6, 0, n, False)
    lay = detect_uniform_layout(rec)
    c = torch.from_numpy(rec).cuda()
    args = dict(rs=lay.rs, o1=lay.o1, o2=lay.o2, o3=lay.o3, width=256,
                q_lo=int(sanger.LOWER), q_hi=int(sanger.UPPER),
                offset=int(sanger.OFFSET))
    compare(rec, rec.size, lay, 256, sanger, "256 MiB chunk")
    ms = cuda_ms(lambda: uniform_qc(c, rec.size, **args), inner=3)
    plain_ms = cuda_ms(lambda: uniform_qc_torch(c, rec.size, **args),
                       inner=2)
    log("kernel B == plain on %d cases; 256 MiB chunk (%d x %d): kernel "
        "%.3f ms (%.1f GB/s), plain %.3f ms" % (
            n_cases, n, RS, ms, rec.size / ms / 1e6, plain_ms))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


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
    if model.tier_chunks != {"uniform": chunks, "host": 0}:
        raise AssertionError("expected %d uniform chunks and no host "
                             "batch, got %s" % (chunks, model.tier_chunks))
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
    upstream example's shape, QCModel's batch and width, and an edge batch
    (lengths 0 and = width, bytes 0xFE and 0xFF, references of 1 and 1,000
    bytes). Returns the JSON fields (timed at the example's shape) and the
    timings of both timed shapes."""
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
    err = 0
    times = {}
    for label, B, Lq, Lr, read_len, alpha in cases:
        seq = rng.choice(alpha, (B, Lq))
        ref = rng.choice(alpha, Lr)
        lengths = (rng.integers(0, Lq + 1, B) if read_len is None
                   else np.full(B, read_len)).astype(np.int32)
        lengths[:8] = 0
        lengths[8:16] = Lq
        d = [torch.from_numpy(a).cuda() for a in (seq, lengths, ref)]
        got = nw_scores(*d)
        want = nw_scores_torch(*d)
        torch.cuda.synchronize()
        err = max(err, max_abs_diff((got,), (want,), "NW kernel, " + label))
        host = got.cpu().numpy()
        for b in (0, 8, 16, 17):
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
            times[label] = dict(B=B, Lq=Lq, Lr=Lr, ms=ms, plain_ms=plain_ms)
            log("NW kernel [%d, %d] vs Lr=%d: kernel %.4f ms, plain %.3f ms"
                % (B, Lq, Lr, ms, plain_ms))
    log("NW kernel == plain on %d shapes" % len(cases))
    return dict(max_abs_err=err, ms=times["example"]["ms"],
                plain_ms=times["example"]["plain_ms"]), times


def phase_aligner():
    """NWAligner end to end at the upstream nw_gpu example's scale: host
    parse into padded batches of 65,536, scores on the card, the first
    2,000 against the numpy twin."""
    import torch

    import blazeseq_tpu as bt
    from blazeseq_tpu_torch import NWAligner

    t0 = time.perf_counter()
    buf = bytes(bt.generate_synthetic_fastq_buffer(
        NW_READS, NW_READ_LEN, NW_READ_LEN, 2, 40, "sanger"))
    log("aligner corpus: %d reads x %d bp (%d bytes) made in %.1f s"
        % (NW_READS, NW_READ_LEN, len(buf), time.perf_counter() - t0))
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


def phase_align_run_file(seed, files, oracle):
    """QCModel(align_to=..., adapters, duplicates, quartiles).run_file on
    1M reads x 150 bp on the card: core panels against the oracle, 2,000
    alignment scores against the numpy twin, and every panel of a
    20,000-read prefix against the same call on the CPU."""
    import torch

    import blazeseq_tpu as bt
    from blazeseq_tpu_torch import QCModel
    from blazeseq_tpu_torch.ops.nw import needleman_wunsch_cpu

    ref = np.random.default_rng([seed, 4]).choice(
        np.frombuffer(b"ACGT", np.uint8), READ_LEN).tobytes()
    kw = dict(quality_schema="sanger", align_to=ref, adapters=[ADAPTER],
              track_duplicates=True, track_quartiles=True)
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
    size = ALIGN_READS * RS
    log("run_file(align_to, adapters, duplicates, quartiles): %d reads "
        "in %.3f s, %.0f reads/s, %.3f GB/s; adapter in %d reads, "
        "unique %.4f; first %d scores == numpy twin"
        % (ALIGN_READS, wall, ALIGN_READS / wall, size / wall / 1e9,
           hits, rep.frac_unique_reads, TWIN_SAMPLE))
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
    64 MiB of bytes drawn from {'\\n', '@', '+', 'A'}, and
    count_records_device at N = 1, 127, 129 and 128k + 5 (zero padding).
    Both timed on the 256 MiB chunk."""
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
    for n in (1, 127, 129, 128 * 1024 + 5):
        want = compare(_pad_lane(big[:n]), "N=%d" % n)
        got = count_records_device(big[:n])
        expect = int(np.count_nonzero(host[:n] == 10)) // 4
        if (got.dtype != torch.int32 or got.dim() != 0
                or int(got) != expect
                or int(want[3].sum()) // 4 != expect):
            raise AssertionError("count_records_device(N=%d): %r, want %d"
                                 % (n, got, expect))
    ms = cuda_ms(lambda: structural_bitmaps(big))
    plain_ms = cuda_ms(lambda: structural_bitmaps_torch(big), inner=2)
    log("scan kernel == plain on %d cases; 256 MiB chunk: kernel %.4f ms "
        "(%.1f GB/s), plain %.3f ms" % (n_cases, ms, big.numel() / ms / 1e6,
                                        plain_ms))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def phase_device_parse(seed, tmp):
    """The device-parse API on a 1 GiB ragged FASTQ fed in 256 MiB chunks:
    raw_stream_qc, count_records_device(chunk[:tail_start]) == reads, and
    parse_fastq_device; the partial tail goes to the next chunk. Totals
    against the host parser, composition and Phred histogram against the
    generator, every code 0, 2,000 sampled rows against the host parser's
    bytes, and a planted '@' -> 'X' giving code 1 at its record."""
    import torch

    import blazeseq_tpu as bt
    from blazeseq_tpu_torch.ops.raw_stats import raw_stream_qc
    from blazeseq_tpu_torch.ops.scan import (count_records_device,
                                             parse_fastq_device)

    path = os.path.join(tmp, "ragged.fastq")
    t0 = time.perf_counter()
    oracle, starts = write_ragged_corpus(path, RAGGED_BYTES, seed + 23)
    n_total = oracle["reads"]
    log("ragged corpus: %d records, %d bytes, written in %.1f s"
        % (n_total, oracle["bytes"], time.perf_counter() - t0))
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
    os.unlink(path)
    size = oracle["bytes"]
    log("device_parse: %d bytes, %d reads, %d bases in %d chunks: %.3f s "
        "wall, %.3f GB/s; totals == host parser, composition and Phred "
        "histogram == generator, %d sampled rows == host parser, planted "
        "corruption -> code 1" % (size, tot["reads"], tot["bases"], chunks,
                                  wall, size / wall / 1e9, TWIN_SAMPLE))
    return dict(bytes=size, reads=tot["reads"], wall_s=wall,
                gbps=size / wall / 1e9)


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
    import blazeseq_tpu as bt

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
    import blazeseq_tpu as bt
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


def phase_cli(files, oracle, tmp):
    """python -m blazeseq_tpu_torch in-process with device="cuda": stats,
    stats --device, trim in three modes, demux --mismatches 1, merge and
    tiles on the 1M-read file (merge on MATE_PAIRS pairs), each checked
    against the host twins; then each on the 20,000-read (pair) prefix on
    the card and on the CPU, stdout and output files byte-equal."""
    times = {}
    for name, argv in CLI_COMMANDS:
        full = os.path.join(tmp, "cli_full")
        args = [a.format(out=full, **{"in": files["align"], "r1": files["r1"],
                                      "r2": files["r2"]}) for a in argv]
        text, _, wall = _cli(args, "cuda", full)
        _cli_twin_check(name, files, oracle, text, full)
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


def run_path(name, fn, kernels):
    """Drive one path with every launch count set to 0 just before it;
    returns its result and the counts read just after. Raises when a kernel
    of the path was never launched."""
    import torch

    for k in kernels.values():
        k.launches = 0
    out = fn()
    torch.cuda.synchronize()
    got = {name_: k.launches for name_, k in kernels.items()}
    log("launches on the %s path: %s" % (name, got))
    return out, got


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch

    t_start = time.perf_counter()
    name, smi = phase_card()
    from blazeseq_tpu_torch.ops.nw import nw_scores
    from blazeseq_tpu_torch.ops.scan import structural_bitmaps
    from blazeseq_tpu_torch.ops.uniform_qc import uniform_qc
    from blazeseq_tpu_torch.ops.validate import validate_decode

    kernels = dict(uniform_qc=uniform_qc, validate_decode=validate_decode,
                   nw_scores=nw_scores, structural_bitmaps=structural_bitmaps)
    phase_build()
    torch.cuda.synchronize()
    ka = phase_kernel_a(args.seed)
    torch.cuda.synchronize()
    kb = phase_kernel_b(args.seed)
    torch.cuda.synchronize()
    knw, nw_times = phase_kernel_nw(args.seed)
    torch.cuda.synchronize()
    kscan = phase_kernel_scan(args.seed)
    torch.cuda.synchronize()
    # each path: (name, phase, the kernels it must launch)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    align = {}
    paths = [
        ("run_file_device", lambda: phase_main_path(args.seed, tmp),
         ("uniform_qc",)),
        ("fallback", lambda: phase_fallback(args.seed, tmp),
         ("validate_decode",)),
        ("NWAligner", phase_aligner, ("nw_scores",)),
        ("run_file(align_to)",
         lambda: phase_align_run_file(args.seed, *align["corpus"]),
         ("validate_decode", "nw_scores")),
        ("device_parse", lambda: phase_device_parse(args.seed, tmp),
         ("structural_bitmaps",)),
        ("cli", lambda: phase_cli(*align["corpus"], tmp),
         ("uniform_qc", "validate_decode")),
    ]
    e2e = {}
    launches = dict.fromkeys(kernels, 0)
    try:
        align["corpus"] = make_align_corpus(args.seed, tmp)
        for path_name, fn, needed in paths:
            e2e[path_name], got = run_path(path_name, fn, kernels)
            for k in needed:
                if got[k] == 0:
                    raise AssertionError("kernel %s was never launched on "
                                         "the %s path" % (k, path_name))
            for k, v in got.items():
                launches[k] += v
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log("launches on the paths, summed:", launches)
    log("NW kernel timings:", json.dumps(nw_times))
    log("end to end:", json.dumps(e2e))
    log("total %.1f s" % (time.perf_counter() - t_start))
    print(json.dumps({"kernels": [
        dict(name="uniform_qc", route="cuda", source=KERNEL_B_SOURCE,
             replaces="blazeseq_tpu/ops/fused_qc.py:205",
             launches=launches["uniform_qc"], **kb),
        dict(name="validate_decode", route="cuda", source=KERNEL_A_SOURCE,
             replaces="blazeseq_tpu/ops/validate.py:94",
             launches=launches["validate_decode"], **ka),
        dict(name="nw_scores", route="cuda", source=KERNEL_NW_SOURCE,
             replaces="blazeseq_tpu/ops/nw.py:174",
             launches=launches["nw_scores"], **knw),
        dict(name="structural_bitmaps", route="cuda",
             source=KERNEL_SCAN_SOURCE,
             replaces="blazeseq_tpu/ops/scan.py:78",
             launches=launches["structural_bitmaps"], **kscan),
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
