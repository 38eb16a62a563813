"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--seed N]

Builds the port's CUDA kernels from blazeseq_tpu_torch/csrc (one nvcc per
source, all started together), holds each kernel against its plain torch
version on the card, then drives the port's paths, each with the launch
counts set to 0 just before it and read just after:

* QCModel(device="cuda").run_file_device over a 4 GiB uniform FASTQ file
  and a 1 GiB quality-binned one, each checked panel by panel against an
  independent numpy oracle;
* its fallback route (a mid-file quality error and a trailing partial
  record) against the same call on the CPU;
* NWAligner on 1M reads x 40 bp against a 40 bp reference in batches of
  65,536, the first 2,000 scores against the numpy twin;
* QCModel(align_to=..., adapters, duplicates, quartiles).run_file on 1M
  reads x 150 bp: core panels against the oracle, 2,000 alignment scores
  against the numpy twin, and every panel of a 20,000-read prefix against
  the same call on the CPU.

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
# the upstream nw_gpu example: 1M reads x 40 bp against a 40 bp reference
NW_READS = 1_000_000
NW_READ_LEN = 40
NW_BATCH = 65536
NW_REFERENCE = b"GATTACAGATTACAGATTACAGATTACAGATTACAGATTA"
ADAPTER = b"AGATCGGAAGAG"
ALIGN_READS = 1_000_000
ALIGN_PREFIX_READS = 20_000
TWIN_SAMPLE = 2_000


def log(*a):
    print(*a, flush=True)


# ------------------------------------------------------------- the corpus

def _make_block(seed, block, start, n, binned, planted=False):
    """Records [start, start+n) as a u8[n, RS] matrix, and their oracle
    partials (int64 numpy). `planted`: every 8th read carries ADAPTER at a
    random offset and every 16th copies one of its block's first 64
    reads."""
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
        la = len(ADAPTER)
        rows = np.arange(0, n, 8)
        offs = rng.integers(0, READ_LEN - la + 1, len(rows))
        # draws 0..3 are A C G T in _SEQ_LUT
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
    """4 GiB uniform FASTQ, then a 1 GiB binned one, through
    QCModel.run_file_device on the card, against the numpy oracle."""
    need = (4 << 30) + (256 << 20)
    free = shutil.disk_usage(tmp).free
    if free < need:
        raise RuntimeError("phase 5 needs %d free bytes in %s, found %d"
                           % (need, tmp, free))
    out = {}
    for label, gib, binned in (("main", 4, False), ("binned", 1, True)):
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


def phase_align_run_file(seed, tmp):
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
    path = os.path.join(tmp, "align.fastq")
    prefix = os.path.join(tmp, "align_prefix.fastq")
    t0 = time.perf_counter()
    oracle = write_corpus(path, ALIGN_READS, seed + 17, planted=True)
    with open(path, "rb") as f:
        head = f.read(ALIGN_PREFIX_READS * RS)
    with open(prefix, "wb") as f:
        f.write(head)
    log("align corpus: %d records of %d bytes written in %.1f s"
        % (ALIGN_READS, RS, time.perf_counter() - t0))
    try:
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
    finally:
        os.unlink(path)
        os.unlink(prefix)
    return dict(reads=ALIGN_READS, bytes=size, wall_s=wall,
                reads_per_s=ALIGN_READS / wall, gbps=size / wall / 1e9)


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
    from blazeseq_tpu_torch.ops.uniform_qc import uniform_qc
    from blazeseq_tpu_torch.ops.validate import validate_decode

    kernels = dict(uniform_qc=uniform_qc, validate_decode=validate_decode,
                   nw_scores=nw_scores)
    phase_build()
    torch.cuda.synchronize()
    ka = phase_kernel_a(args.seed)
    torch.cuda.synchronize()
    kb = phase_kernel_b(args.seed)
    torch.cuda.synchronize()
    knw, nw_times = phase_kernel_nw(args.seed)
    torch.cuda.synchronize()
    # each path: (name, phase, the kernels it must launch)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    paths = [
        ("run_file_device", lambda: phase_main_path(args.seed, tmp),
         ("uniform_qc",)),
        ("fallback", lambda: phase_fallback(args.seed, tmp),
         ("validate_decode",)),
        ("NWAligner", phase_aligner, ("nw_scores",)),
        ("run_file(align_to)", lambda: phase_align_run_file(args.seed, tmp),
         ("validate_decode", "nw_scores")),
    ]
    e2e = {}
    launches = dict.fromkeys(kernels, 0)
    try:
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
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
