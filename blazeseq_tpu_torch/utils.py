"""Synthetic corpus generators + size estimators
(reference: blazeseq/utils.mojo:640-1139).

The generation model is an exact port of the reference's deterministic scheme
so corpora are bit-identical across the two implementations (required for
benchmark cross-checks, SURVEY.md §7.1):

* read length: min + ((i*31 + 7) % (max - min + 1))            (utils.mojo:752-757)
* bases: Knuth MMIX LCG seeded per read, state masked to 63 bits each step,
  slot = (state >> 33) % 8 into a GC-biased 8-entry LUT        (utils.mojo:771-783)
* quality: linear positional decay ("ski slope") + LCG jitter  (utils.mojo:795-827)

Implementation note: masking with 0x7FFF..F makes the recurrence an LCG mod
2^63, which keeps its affine structure — so the whole per-base chain is
vectorized here with precomputed A^p / C_p tables instead of a scalar loop.
"""

from __future__ import annotations

import numpy as np

from .fastq.quality import parse_schema

_MASK63 = np.uint64(0x7FFFFFFFFFFFFFFF)
_A = 6364136223846793005
_C = 1442695040888963407
_QA = 1664525
_QC = 1013904223


def compute_num_reads_for_size(target_size_bytes: int, min_length: int,
                               max_length: int) -> int:
    """Estimate read count for a target byte size (reference: utils.mojo:640-678)."""
    if target_size_bytes <= 0:
        return 0
    avg = (min_length + max_length) // 2
    est = target_size_bytes // (15 + 2 * avg + 4)
    if est <= 0:
        return 0
    num_digits = len(str(est - 1)) if est > 1 else 1
    header_size = 6 + num_digits + 1
    return target_size_bytes // (header_size + 2 * avg + 4)


def _gc_biased_base_lut(gc_bias: float) -> np.ndarray:
    """8-slot base LUT with floor(gc_bias*8+0.5) G/C slots, alternating
    (reference: utils.mojo:708-733)."""
    gc_slots = int(gc_bias * 8.0 + 0.5)
    gc_slots = min(max(gc_slots, 0), 8)
    lut = []
    for k in range(gc_slots):
        lut.append(ord("G") if k % 2 == 0 else ord("C"))
    for k in range(8 - gc_slots):
        lut.append(ord("A") if k % 2 == 0 else ord("T"))
    return np.array(lut, dtype=np.uint8)


def _affine_tables(A: int, c: int, max_steps: int):
    """A^p (p=1..max_steps) and C_p = c * sum_{j<p} A^j, all mod 2^64."""
    apow = np.empty(max_steps, dtype=np.uint64)
    cpre = np.empty(max_steps, dtype=np.uint64)
    a_acc, c_acc = 1, 0
    for p in range(max_steps):
        c_acc = (a_acc * c + c_acc) % (1 << 64)
        a_acc = (a_acc * A) % (1 << 64)
        apow[p] = a_acc
        cpre[p] = c_acc
    return apow, cpre


def generate_synthetic_fastq_buffer(
    num_reads: int,
    min_length: int,
    max_length: int,
    min_phred: int,
    max_phred: int,
    quality_schema: str,
    gc_bias: float = 0.5,
    _chunk_reads: int = 65536,
) -> bytearray:
    """Generate an in-memory FASTQ buffer, bit-identical to the reference
    generator (utils.mojo:831-917)."""
    if num_reads <= 0:
        return bytearray()
    if min(num_reads, min_length, max_length, min_phred, max_phred) < 0:
        raise ValueError("generate_synthetic_fastq_buffer: invalid arguments")
    if min_length > max_length:
        raise ValueError(
            "generate_synthetic_fastq_buffer: min_length must be <= max_length")
    if min_phred > max_phred:
        raise ValueError(
            "generate_synthetic_fastq_buffer: min_phred must be <= max_phred")

    schema = parse_schema(quality_schema)
    offset_i, lower_i, upper_i = schema.OFFSET, schema.LOWER, schema.UPPER
    base_lut = _gc_biased_base_lut(gc_bias)

    # native fast path (bit-identical; blazeseq_tpu/native/scan.cpp
    # bs_generate_fastq)
    from . import native

    nat = native.generate_fastq(
        0, num_reads, num_reads, min_length, max_length, min_phred,
        max_phred, offset_i, lower_i, upper_i, base_lut)
    if nat is not None:
        return bytearray(nat.tobytes())

    num_digits = len(str(num_reads - 1)) if num_reads > 1 else 1
    header_size = 6 + num_digits + 1

    q_start = max_phred
    q_range = q_start - min_phred
    noise_amp = (q_range // 6) + 1

    apow_s, cpre_s = _affine_tables(_A, _C, max_length)
    apow_q, cpre_q = _affine_tables(_QA, _QC, max_length)
    pos = np.arange(max_length, dtype=np.int64)

    out = bytearray()
    err = np.seterr(over="ignore")
    try:
        for c0 in range(0, num_reads, _chunk_reads):
            idx = np.arange(c0, min(c0 + _chunk_reads, num_reads), dtype=np.uint64)
            out += _gen_chunk(
                idx, min_length, max_length, min_phred, max_phred,
                num_digits, header_size, offset_i, lower_i, upper_i,
                q_start, q_range, noise_amp, base_lut,
                apow_s, cpre_s, apow_q, cpre_q, pos,
            )
    finally:
        np.seterr(**err)
    return out


def _gen_chunk(idx, min_length, max_length, min_phred, max_phred, num_digits,
               header_size, offset_i, lower_i, upper_i, q_start, q_range,
               noise_amp, base_lut, apow_s, cpre_s, apow_q, cpre_q, pos):
    n = len(idx)
    if max_length == min_length:
        lens = np.full(n, min_length, dtype=np.int64)
    else:
        lens = min_length + (
            (idx.astype(np.int64) * 31 + 7) % (max_length - min_length + 1))
    P = int(lens.max()) if n else 0

    # --- sequence states: s0 = (i*A + C); base p uses A^(p+1)*s0 + C_p mod 2^63
    s0 = idx * np.uint64(_A) + np.uint64(_C)
    states = (apow_s[None, :P] * s0[:, None] + cpre_s[None, :P]) & _MASK63
    slots = (states >> np.uint64(33)) % np.uint64(8)
    seq_mat = base_lut[slots.astype(np.int64)]

    # --- quality states
    q0 = idx * np.uint64(2654435761) + np.uint64(_QC)
    qstates = (apow_q[None, :P] * q0[:, None] + cpre_q[None, :P]) & _MASK63
    noise_raw = ((qstates >> np.uint64(17)) %
                 np.uint64(2 * noise_amp + 1)).astype(np.int64)
    lm1 = (lens - 1)[:, None]
    with np.errstate(divide="ignore", invalid="ignore"):
        decay = np.where(
            lm1 > 0, (q_range * pos[None, :P] + lm1 // 2) // np.maximum(lm1, 1), 0)
    phred = q_start - decay + noise_raw - noise_amp
    phred = np.clip(phred, min_phred, max_phred)
    qual_mat = np.clip(offset_i + phred, lower_i, upper_i).astype(np.uint8)

    # --- assemble records: @read_<digits>\n SEQ \n + \n QUAL \n
    # header (incl. '\n') + seq + '\n' + '+\n' + qual + '\n'
    rec_sizes = header_size + 2 * lens + 4
    starts = np.concatenate([[0], np.cumsum(rec_sizes)[:-1]])
    total = int(rec_sizes.sum())
    out = np.empty(total, dtype=np.uint8)

    head = np.frombuffer(b"@read_", dtype=np.uint8)
    out[(starts[:, None] + np.arange(6)).ravel()] = np.tile(head, n)
    # zero-padded decimal digits of idx
    ii = idx.astype(np.int64)
    for k in range(num_digits):
        digit = (ii // (10 ** (num_digits - 1 - k))) % 10
        out[starts + 6 + k] = (48 + digit).astype(np.uint8)
    out[starts + 6 + num_digits] = 10  # \n

    colmask = pos[None, :P] < lens[:, None]
    seq_pos = starts[:, None] + header_size + pos[None, :P]
    out[seq_pos[colmask]] = seq_mat[colmask]
    nl1 = starts + header_size + lens
    out[nl1] = 10
    out[nl1 + 1] = ord("+")
    out[nl1 + 2] = 10
    qual_pos = nl1[:, None] + 3 + pos[None, :P]
    out[qual_pos[colmask]] = qual_mat[colmask]
    out[nl1 + 3 + lens] = 10
    return out.tobytes()


def generate_synthetic_fastq_to_writer(writer, num_reads, min_length,
                                       max_length, min_phred, max_phred,
                                       quality_schema, gc_bias=0.5):
    """Stream the same synthetic corpus to a BufferedWriter
    (reference: utils.mojo:920-986)."""
    buf = generate_synthetic_fastq_buffer(
        num_reads, min_length, max_length, min_phred, max_phred,
        quality_schema, gc_bias)
    writer.write_bytes(buf)


def compute_num_fasta_reads_for_size(target_size_bytes: int, min_length: int,
                                     max_length: int, line_width: int = 60) -> int:
    """Reference: utils.mojo:989-1025."""
    if target_size_bytes <= 0:
        return 0
    avg = (min_length + max_length) // 2
    seq_newlines = (avg + line_width - 1) // line_width
    est = target_size_bytes // (15 + avg + seq_newlines)
    if est <= 0:
        return 0
    num_digits = len(str(est - 1)) if est > 1 else 1
    header_size = 6 + num_digits + 1
    return target_size_bytes // (header_size + avg + seq_newlines)


def generate_synthetic_fasta_buffer(num_reads: int, min_length: int,
                                    max_length: int, line_width: int = 60,
                                    gc_bias: float = 0.5) -> bytearray:
    """Multiline FASTA generator, same LCG/GC model
    (reference: utils.mojo:1028-1139)."""
    if num_reads <= 0:
        return bytearray()
    if min_length < 0 or max_length < 0:
        raise ValueError(
            "generate_synthetic_fasta_buffer: lengths must be non-negative")
    if min_length > max_length:
        raise ValueError(
            "generate_synthetic_fasta_buffer: min_length must be <= max_length")
    if line_width <= 0:
        raise ValueError(
            "generate_synthetic_fasta_buffer: line_width must be positive")

    base_lut = _gc_biased_base_lut(gc_bias)
    num_digits = len(str(num_reads - 1)) if num_reads > 1 else 1
    apow_s, cpre_s = _affine_tables(_A, _C, max_length)

    out = bytearray()
    err = np.seterr(over="ignore")
    try:
        for i in range(num_reads):
            if max_length == min_length:
                seq_len = min_length
            else:
                seq_len = min_length + ((i * 31 + 7) % (max_length - min_length + 1))
            out += b">read_" + str(i).zfill(num_digits).encode() + b"\n"
            s0 = np.uint64(i) * np.uint64(_A) + np.uint64(_C)
            states = (apow_s[:seq_len] * s0 + cpre_s[:seq_len]) & _MASK63
            slots = (states >> np.uint64(33)) % np.uint64(8)
            seq = base_lut[slots.astype(np.int64)].tobytes()
            for col in range(0, seq_len, line_width):
                out += seq[col : col + line_width] + b"\n"
            if seq_len == 0:
                pass
    finally:
        np.seterr(**err)
    return out


def generate_variable_id_fastq_buffer(
    num_reads: int,
    min_length: int,
    max_length: int,
    min_phred: int,
    max_phred: int,
    quality_schema: str,
    gc_bias: float = 0.5,
    seed: int = 0,
    _chunk_reads: int = 65536,
) -> bytearray:
    """Generate a realistic VARIABLE-LAYOUT FASTQ buffer: Illumina-style
    coordinate-bearing ids (`@SIM:1:FCX:1:<lane>:<x>:<y> <read>:N:0:<i>`)
    whose widths vary per record, plus per-read lengths drawn from
    [min_length, max_length]. This is the corpus the uniform-template device
    path can NEVER accept (header widths differ), exercising the general
    ragged device engine (ops/ragged_qc.py). Deterministic in `seed`.

    Unlike generate_synthetic_fastq_buffer (bit-identical to the reference
    generator, utils.mojo:831-917, fixed-width ids), this generator has no
    reference counterpart: the reference benchmarks only uniform synthetic
    corpora, which is exactly the weakness being closed here.
    """
    if num_reads <= 0:
        return bytearray()
    if min_length > max_length or min_length < 0:
        raise ValueError("generate_variable_id_fastq_buffer: bad lengths")
    schema = parse_schema(quality_schema)
    lo = schema.OFFSET + max(min_phred, schema.LOWER - schema.OFFSET)
    hi = min(schema.OFFSET + max_phred, schema.UPPER)
    lo = min(lo, hi)
    base_lut = _gc_biased_base_lut(gc_bias)
    rng = np.random.default_rng(seed)
    out = bytearray()
    for c0 in range(0, num_reads, _chunk_reads):
        c1 = min(c0 + _chunk_reads, num_reads)
        n = c1 - c0
        lens = rng.integers(min_length, max_length + 1, n)
        xs = rng.integers(1, 30000, n)
        ys = rng.integers(1, 30000, n)
        total = int(lens.sum())
        seq_all = base_lut[rng.integers(0, 8, total)]
        qual_all = rng.integers(lo, hi + 1, total, dtype=np.uint8)
        off = 0
        for j in range(n):
            L = int(lens[j])
            i = c0 + j
            out += b"@SIM:1:FCX:1:%d:%d:%d %d:N:0:%d\n" % (
                i % 8 + 1, xs[j], ys[j], i % 2 + 1, i % 12 + 1)
            out += seq_all[off:off + L].tobytes() + b"\n+\n"
            out += qual_all[off:off + L].tobytes() + b"\n"
            off += L
    return out
