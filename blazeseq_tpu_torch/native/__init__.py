"""Native host-kernel loader with pure-numpy fallback.

Loads (building on first use if needed) the C++ scanning library
`libblazeseq_scan.so` and exposes typed wrappers. When the native library is
unavailable (no compiler, BLAZESEQ_NATIVE=0), a numpy implementation with
identical semantics is used — slower, but bit-identical results.

All functions operate on a numpy uint8 window and return record offset tables:
int64[count, 5] columns (header_start, seq_start, sep_start, qual_start,
record_end), the reference RecordOffsets layout (blazeseq/utils.mojo:39-93).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile
from typing import NamedTuple, Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "scan.cpp")
_LIB_NAME = "libblazeseq_scan.so"

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _shared_candidates(src: str, lib_name: str, extra_flags=()):
    """Yield loadable shared-library paths for `src` (cached by mtime), one
    per candidate dir — callers try each (a stale/foreign artifact in the
    package dir must not disable the native path when the tempdir build
    would work)."""
    out_candidates = [
        os.path.join(_HERE, lib_name),
        os.path.join(tempfile.gettempdir(), "blazeseq_tpu_torch_" + lib_name),
    ]
    for out in out_candidates:
        if (os.path.exists(out)
                and os.path.getmtime(out) >= os.path.getmtime(src)):
            yield out
            continue
        # build under a temporary name, then rename: a process loading the
        # library concurrently never sees a half-written file
        tmp = "%s.%d.tmp" % (out, os.getpid())
        try:
            cmd = (["g++", "-O3", "-march=native", "-shared", "-fPIC"]
                   + list(extra_flags) + [src, "-o", tmp])
            r = subprocess.run(cmd, capture_output=True, timeout=120)
            if r.returncode == 0:
                os.replace(tmp, out)
                yield out
        except (OSError, subprocess.SubprocessError):
            continue
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)


def _build_shared(src: str, lib_name: str,
                  extra_flags=()) -> Optional[str]:
    for out in _shared_candidates(src, lib_name, extra_flags):
        return out
    return None


def _build_lib() -> Optional[str]:
    return _build_shared(_SRC, _LIB_NAME)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("BLAZESEQ_NATIVE", "1") == "0":
        return None
    lib = None
    for path in _shared_candidates(_SRC, _LIB_NAME):
        try:
            lib = ctypes.CDLL(path)
            break
        except OSError:
            continue
    if lib is None:
        return None
    i64, i32, u8 = ctypes.c_int64, ctypes.c_int32, ctypes.c_uint8
    p_u8 = ctypes.POINTER(ctypes.c_uint8)
    p_i64 = ctypes.POINTER(ctypes.c_int64)
    p_i32 = ctypes.POINTER(ctypes.c_int32)
    lib.bs_scan_fastq.restype = i64
    lib.bs_scan_fastq.argtypes = [
        p_u8, i64, i64, i64, i32, i32, u8, u8, p_i64, p_i64, p_i32, p_i32,
    ]
    lib.bs_count_fastq.restype = i64
    lib.bs_count_fastq.argtypes = [
        p_u8, i64, i64, i32, i32, u8, u8, p_i64, p_i64, p_i32, p_i32,
    ]
    lib.bs_find_newlines.restype = i64
    lib.bs_find_newlines.argtypes = [p_u8, i64, p_i64, i64]
    lib.bs_gather_soa.restype = i64
    lib.bs_gather_soa.argtypes = [p_u8, p_i64, i64, p_u8, p_u8, p_i64]
    lib.bs_gather_ids.restype = i64
    lib.bs_gather_ids.argtypes = [p_u8, p_i64, i64, p_u8, p_i64]
    lib.bs_gather_padded.restype = None
    lib.bs_gather_padded.argtypes = [p_u8, p_i64, i64, i64, p_u8, p_u8, p_i32]
    lib.bs_pad_rows.restype = None
    lib.bs_pad_rows.argtypes = [p_u8, p_u8, p_i64, i64, i64, i64, p_u8, p_u8,
                                p_i32]
    lib.bs_scan_fasta.restype = i64
    lib.bs_scan_fasta.argtypes = [
        p_u8, i64, i64, i32, i64, i32, p_u8, p_i64, p_u8, p_i64,
        p_i64, p_i64, p_i32, p_i64,
    ]
    lib.bs_count_fasta.restype = i64
    lib.bs_count_fasta.argtypes = [p_u8, i64, i64, i32, p_i64, p_i64, p_i64,
                                   p_i32]
    lib.bs_generate_fastq.restype = i64
    lib.bs_generate_fastq.argtypes = [
        i64, i64, i64, i64, i64, i64, i64, i32, i32, i32, p_u8, p_u8,
    ]
    lib.bs_scan_gather_padded.restype = i64
    lib.bs_scan_gather_padded.argtypes = [
        p_u8, i64, i64, i64, i64, i32, i32, u8, u8, i64,
        p_u8, p_u8, p_i32, p_i64, p_i32, p_i32,
    ]
    lib.bs_scan_gather_soa.restype = i64
    lib.bs_scan_gather_soa.argtypes = [
        p_u8, i64, i64, i64, i64, i64, i32, i32, u8, u8,
        p_u8, p_u8, p_i64, p_u8, p_i64, p_i64, p_i64, p_i64, p_i32, p_i32,
    ]
    lib.bs_serialize_fastq.restype = i64
    lib.bs_serialize_fastq.argtypes = [
        p_u8, p_i64, p_i64, p_u8, p_u8, p_i64, p_i64, i64, p_u8, i64,
    ]
    lib.bs_normalize_semi_uniform.restype = i64
    lib.bs_normalize_semi_uniform.argtypes = [
        p_u8, i64, i64, p_u8, i64, i64, i64, p_i64,
    ]
    _lib = lib
    return _lib


def has_native() -> bool:
    return _load() is not None


_pz_lib: Optional[ctypes.CDLL] = None
_pz_tried = False


def pinflate_lib():
    """Load (building on first use) the parallel-inflate core
    (pinflate.cpp). Returns the CDLL or None."""
    global _pz_lib, _pz_tried
    if _pz_tried:
        return _pz_lib
    _pz_tried = True
    if os.environ.get("BLAZESEQ_NATIVE", "1") == "0":
        return None
    for path in _shared_candidates(os.path.join(_HERE, "pinflate.cpp"),
                                   "libblazeseq_pinflate.so"):
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            continue
        i64, i32 = ctypes.c_int64, ctypes.c_int32
        p_u8 = ctypes.POINTER(ctypes.c_uint8)
        p_u16 = ctypes.POINTER(ctypes.c_uint16)
        p_i64 = ctypes.POINTER(ctypes.c_int64)
        p_i32 = ctypes.POINTER(ctypes.c_int32)
        lib.pz_decode_chunk.restype = i64
        lib.pz_decode_chunk.argtypes = [p_u8, i64, i64, i64, p_u16, i64,
                                        p_i64, p_i32, p_i32]
        lib.pz_find_block.restype = i64
        lib.pz_find_block.argtypes = [p_u8, i64, i64, i64, i64, p_u16, i64]
        lib.pz_resolve.restype = i32
        lib.pz_resolve.argtypes = [p_u16, i64, p_u8, p_u8]
        lib.pz_narrow.restype = None
        lib.pz_narrow.argtypes = [p_u16, i64, p_u8]
        lib.pz_last_marker.restype = i64
        lib.pz_last_marker.argtypes = [p_u16, i64]
        _pz_lib = lib
        return _pz_lib
    return None


_rec_mod = None
_rec_tried = False


def records_ext():
    """Load (building on first use) the CPython fast-path extension for
    owned-record iteration (records_ext.c). Returns the module or None."""
    global _rec_mod, _rec_tried
    if _rec_tried:
        return _rec_mod
    _rec_tried = True
    if os.environ.get("BLAZESEQ_NATIVE", "1") == "0":
        return None
    import importlib.util
    import sysconfig

    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    for path in _shared_candidates(
            os.path.join(_HERE, "records_ext.c"), "_records" + suffix,
            extra_flags=("-I", sysconfig.get_paths()["include"])):
        try:
            spec = importlib.util.spec_from_file_location("_records", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            _rec_mod = mod
            return _rec_mod
        except Exception:
            continue
    return None


class ScanResult(NamedTuple):
    offsets: np.ndarray  # int64[count, 5]
    consumed: int  # bytes consumed (next record start)
    err_code: int  # FastxErrorCode value (0 = OK)
    err_phase: int  # newlines found in the trailing partial record (0..3)
    err_offsets: Optional[np.ndarray]  # partial offsets of a structure-error record


def aligned_empty(shape, dtype=np.uint8, align: int = 64) -> np.ndarray:
    """np.empty with the base pointer aligned to `align` bytes. 64-byte
    alignment lets bs_scan_gather_padded use non-temporal row stores (the
    padded rows are written once and consumed by the device transfer, so
    bypassing the cache avoids read-for-ownership bus traffic)."""
    dtype = np.dtype(dtype)
    size = int(np.prod(shape)) * dtype.itemsize
    raw = np.empty(size + align, dtype=np.uint8)
    off = (-raw.ctypes.data) % align
    return raw[off : off + size].view(dtype).reshape(shape)


_fast_scan_mod = None
_fast_scan_tried = False


def _fast_scan():
    """records_ext METH_FASTCALL trampolines bound to the scan library.
    The ctypes bindings cost ~25us per call (measured; pointer wrappers +
    byref cells); the trampolines take the same numpy buffers through the
    buffer protocol at ~1us — material at one call per batch window."""
    global _fast_scan_mod, _fast_scan_tried
    if _fast_scan_tried:
        return _fast_scan_mod
    _fast_scan_tried = True
    lib = _load()
    mod = records_ext()
    if lib is None or mod is None or not hasattr(mod, "bind_scan"):
        return None
    try:
        mod.bind_scan(
            ctypes.cast(lib.bs_scan_gather_soa, ctypes.c_void_p).value,
            ctypes.cast(lib.bs_scan_gather_padded, ctypes.c_void_p).value)
        _fast_scan_mod = mod
    except Exception:
        _fast_scan_mod = None
    return _fast_scan_mod


def _ptr_u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _ptr_i64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def scan_fastq(
    window: np.ndarray,
    start: int = 0,
    max_records: int = 2**62,
    check_ascii: bool = False,
    check_quality: bool = False,
    q_lower: int = 33,
    q_upper: int = 126,
    scratch: Optional[np.ndarray] = None,
) -> ScanResult:
    """Scan `window[start:]` for complete FASTQ records with fused validation.

    Mirrors bs_scan_fastq (scan.cpp): structure errors leave the bad record
    uncounted (its partial offsets returned in err_offsets); validation errors
    count & consume the bad record as the last row.

    `scratch` (int64[(cap+1), 5]) reuses an offsets buffer across scans —
    the returned offsets VIEW it, so callers must drain the result before
    the next scan with the same scratch (the parser's queue contract). A
    scan that fills the scratch simply stops early; the caller's refill loop
    continues from `consumed`.
    """
    lib = _load()
    n = len(window)
    if lib is not None:
        if scratch is not None:
            cap = min(max_records, len(scratch) - 1)
            out = scratch
        else:
            # Upper bound for record count in this window: each record needs
            # >= 4 bytes; cap the allocation — a full scratch just means the
            # caller scans again from `consumed`.
            cap = min(max_records, (n - start) // 4 + 1) if n > start else 0
            cap = max(min(cap, 1 << 20), 1)
            out = np.empty((cap + 1, 5), dtype=np.int64)
        consumed = ctypes.c_int64(0)
        err_code = ctypes.c_int32(0)
        err_phase = ctypes.c_int32(0)
        count = lib.bs_scan_fastq(
            _ptr_u8(window), n, start, cap,
            1 if check_ascii else 0, 1 if check_quality else 0,
            q_lower, q_upper - q_lower,
            _ptr_i64(out), ctypes.byref(consumed),
            ctypes.byref(err_code), ctypes.byref(err_phase),
        )
        err_off = None
        if err_code.value in (1, 2, 3):
            err_off = out[count].copy()
        return ScanResult(
            out[:count], consumed.value, err_code.value, err_phase.value, err_off
        )
    return _scan_fastq_np(
        window, start, max_records, check_ascii, check_quality, q_lower, q_upper
    )


def normalize_semi_uniform(window: np.ndarray, start: int, out: np.ndarray,
                           idw: int, L: int):
    """Rewrite the semi-uniform FASTQ region `window[start:]` (fixed
    seq/qual length L, bare '+' separators, id text <= idw bytes) into
    `out` as a UNIFORM layout with stride rs = idw + 2*L + 6, ids padded
    with trailing spaces. Mirrors bs_normalize_semi_uniform (scan.cpp):
    stops at the first non-matching record, a partial tail, or when `out`
    is full. Returns (records_written, src_bytes_consumed); consumed is a
    record boundary. The space padding is QC-invisible (no stat reads id
    bytes) and the device template proof re-verifies the produced bytes,
    so a false accept only costs a chunk fallback, never exactness."""
    lib = _load()
    if lib is not None:
        consumed = ctypes.c_int64(0)
        count = lib.bs_normalize_semi_uniform(
            _ptr_u8(window), len(window), start, _ptr_u8(out), len(out),
            idw, L, ctypes.byref(consumed))
        return int(count), int(consumed.value)
    return _normalize_semi_uniform_np(window, start, out, idw, L)


def _normalize_semi_uniform_np(window: np.ndarray, start: int,
                               out: np.ndarray, idw: int, L: int):
    """Vectorized numpy twin of bs_normalize_semi_uniform: groups newlines
    in fours (valid while every prior record is a well-formed 4-line
    record — the cut at the first mismatch keeps the grouping
    self-consistent) and gathers id/seq/qual rows into the padded
    layout."""
    rs = idw + 2 * L + 6
    cap = len(out) // rs
    sub = window[start:]
    nl = np.flatnonzero(sub == 10)
    k = len(nl) // 4
    if k == 0 or cap == 0:
        return 0, start
    id_nl = nl[0:4 * k:4]
    seq_nl = nl[1:4 * k:4]
    sep_nl = nl[2:4 * k:4]
    qual_nl = nl[3:4 * k:4]
    starts = np.empty(k, np.int64)
    starts[0] = 0
    starts[1:] = qual_nl[:-1] + 1
    okm = sub[starts] == ord("@")
    okm &= (id_nl - starts - 1) <= idw
    okm &= (seq_nl - id_nl - 1) == L
    okm &= (sep_nl - seq_nl) == 2
    okm &= sub[np.minimum(seq_nl + 1, len(sub) - 1)] == ord("+")
    okm &= (qual_nl - sep_nl - 1) == L
    bad = np.flatnonzero(~okm)
    count = int(bad[0]) if len(bad) else k
    count = min(count, cap)
    if count == 0:
        return 0, start
    o = out[: count * rs].reshape(count, rs)
    o[:, 0] = ord("@")
    idlen = (id_nl - starts - 1)[:count, None]
    idx_id = starts[:count, None] + 1 + np.arange(idw)[None, :]
    o[:, 1:1 + idw] = np.where(np.arange(idw)[None, :] < idlen,
                               sub[np.minimum(idx_id, len(sub) - 1)], 32)
    o[:, idw + 1] = 10
    o[:, idw + 2:idw + 2 + L] = sub[id_nl[:count, None] + 1
                                    + np.arange(L)[None, :]]
    o[:, idw + 2 + L] = 10
    o[:, idw + 3 + L] = ord("+")
    o[:, idw + 4 + L] = 10
    o[:, idw + 5 + L:idw + 5 + 2 * L] = sub[sep_nl[:count, None] + 1
                                            + np.arange(L)[None, :]]
    o[:, idw + 5 + 2 * L] = 10
    return count, start + int(qual_nl[count - 1] + 1)


def _scan_fastq_np(
    window: np.ndarray,
    start: int,
    max_records: int,
    check_ascii: bool,
    check_quality: bool,
    q_lower: int,
    q_upper: int,
) -> ScanResult:
    """Numpy fallback with identical semantics to bs_scan_fastq."""
    sub = window[start:]
    nl = np.flatnonzero(sub == 10).astype(np.int64)
    if start:
        nl += start
    n_complete = min(len(nl) // 4, max_records)
    phase = int(len(nl) - n_complete * 4) if n_complete * 4 <= len(nl) else 0
    if n_complete == len(nl) // 4:
        phase = int(len(nl) % 4)
    else:
        phase = 0  # capped by max_records, not by data

    if n_complete == 0:
        return ScanResult(
            np.empty((0, 5), dtype=np.int64), start, 0, phase, None
        )
    nl4 = nl[: n_complete * 4].reshape(n_complete, 4)
    offsets = np.empty((n_complete, 5), dtype=np.int64)
    offsets[0, 0] = start
    offsets[1:, 0] = nl4[:-1, 3] + 1
    offsets[:, 1] = nl4[:, 0] + 1
    offsets[:, 2] = nl4[:, 1] + 1
    offsets[:, 3] = nl4[:, 2] + 1
    offsets[:, 4] = nl4[:, 3]

    # Structure checks, vectorized (reference: utils.mojo:449-462).
    bad_at = window[offsets[:, 0]] != 64  # '@'
    bad_plus = window[offsets[:, 2]] != 43  # '+'
    seq_len = offsets[:, 2] - offsets[:, 1] - 1
    qual_len = offsets[:, 4] - offsets[:, 3]
    bad_len = seq_len != qual_len
    bad_any = bad_at | bad_plus | bad_len
    err_code = 0
    err_off = None
    count = n_complete
    if bad_any.any():
        k = int(np.argmax(bad_any))
        if bad_at[k]:
            err_code = 1
        elif bad_plus[k]:
            err_code = 2
        else:
            err_code = 3
        err_off = offsets[k].copy()
        count = k
        offsets = offsets[:k]
        phase = 0

    consumed = int(offsets[-1, 4]) + 1 if count else start

    if count and (check_ascii or check_quality):
        vcode, vidx = _validate_np(
            window, offsets, check_ascii, check_quality, q_lower, q_upper
        )
        if vidx >= 0:
            # validation failure: bad record is counted & consumed
            offsets = offsets[: vidx + 1]
            count = vidx + 1
            consumed = int(offsets[-1, 4]) + 1
            err_code = vcode
            err_off = None
            phase = 0
    return ScanResult(offsets, consumed, err_code, phase, err_off)


def _segment_reduce(ufunc, data: np.ndarray, starts: np.ndarray, ends: np.ndarray, empty_val):
    """Per-segment reduction via np.ufunc.reduceat; empty segments get empty_val."""
    nseg = len(starts)
    if nseg == 0:
        return np.empty(0, dtype=data.dtype)
    bounds = np.empty(nseg * 2, dtype=np.int64)
    bounds[0::2] = starts
    bounds[1::2] = ends
    # reduceat requires indices < len(data); guard trailing segment at the end
    safe = np.minimum(bounds, len(data) - 1)
    res = ufunc.reduceat(data, safe)[0::2]
    return np.where(ends > starts, res, empty_val)


def _validate_np(
    window: np.ndarray,
    offsets: np.ndarray,
    check_ascii: bool,
    check_quality: bool,
    q_lower: int,
    q_upper: int,
):
    """Vectorized ASCII/quality validation; returns (code, first_bad_index|-1)."""
    bad = np.zeros(len(offsets), dtype=bool)
    codes = np.zeros(len(offsets), dtype=np.int32)
    if check_ascii:
        id_seq_or = _segment_reduce(
            np.bitwise_or, window, offsets[:, 0] + 1, offsets[:, 2] - 1, np.uint8(0)
        )
        qual_or = _segment_reduce(
            np.bitwise_or, window, offsets[:, 3], offsets[:, 4], np.uint8(0)
        )
        a_bad = ((id_seq_or | qual_or) & 0x80) != 0
        codes = np.where(a_bad & ~bad, 4, codes)
        bad |= a_bad
    if check_quality:
        qmax = _segment_reduce(
            np.maximum, window, offsets[:, 3], offsets[:, 4], np.uint8(q_lower)
        )
        qmin = _segment_reduce(
            np.minimum, window, offsets[:, 3], offsets[:, 4], np.uint8(q_lower)
        )
        q_bad = (qmax > q_upper) | (qmin < q_lower)
        codes = np.where(q_bad & ~bad, 5, codes)
        bad |= q_bad
    if bad.any():
        k = int(np.argmax(bad))
        return int(codes[k]), k
    return 0, -1


def count_fastq(window: np.ndarray, start: int = 0,
                check_ascii: bool = False, check_quality: bool = False,
                q_lower: int = 33, q_upper: int = 126):
    """Count (records, bases) of complete records in window[start:], with
    optional fused validation (errors reported via err_code; the failing
    record IS counted/consumed, like bs_scan_fastq).

    Returns (records, bases, consumed, err_code, err_phase)."""
    lib = _load()
    n = len(window)
    if lib is not None:
        bases = ctypes.c_int64(0)
        consumed = ctypes.c_int64(0)
        err_code = ctypes.c_int32(0)
        err_phase = ctypes.c_int32(0)
        records = lib.bs_count_fastq(
            _ptr_u8(window), n, start,
            1 if check_ascii else 0, 1 if check_quality else 0,
            q_lower, q_upper - q_lower,
            ctypes.byref(bases), ctypes.byref(consumed),
            ctypes.byref(err_code), ctypes.byref(err_phase),
        )
        return records, bases.value, consumed.value, err_code.value, err_phase.value
    res = _scan_fastq_np(window, start, 2**62, check_ascii, check_quality,
                         q_lower, q_upper)
    offsets = res.offsets
    consumed = res.consumed
    if res.err_code in (4, 5) and len(offsets):
        # count mode leaves the validation-failed record UNCONSUMED so the
        # caller can rescan it for exact error context (bs_count_fastq
        # semantics), unlike scan mode's consume-then-validate ordering
        consumed = int(offsets[-1, 0])
        offsets = offsets[:-1]
    if len(offsets):
        bases = int((offsets[:, 2] - offsets[:, 1] - 1).sum())
    else:
        bases = 0
    return len(offsets), bases, consumed, res.err_code, res.err_phase


def gather_soa(window: np.ndarray, offsets: np.ndarray):
    """Gather (seq_bytes, qual_bytes, ends) SoA arrays for the given records."""
    nrec = len(offsets)
    seq_lens = offsets[:, 2] - offsets[:, 1] - 1
    total = int(seq_lens.sum())
    seq = np.empty(total, dtype=np.uint8)
    qual = np.empty(total, dtype=np.uint8)
    ends = np.empty(nrec, dtype=np.int64)
    if nrec == 0:
        return seq, qual, ends
    lib = _load()
    if lib is not None:
        offs = np.ascontiguousarray(offsets, dtype=np.int64)
        lib.bs_gather_soa(
            _ptr_u8(window), _ptr_i64(offs), nrec,
            _ptr_u8(seq), _ptr_u8(qual), _ptr_i64(ends),
        )
        return seq, qual, ends
    # numpy fallback: boolean-mask ragged gather
    np.cumsum(seq_lens, out=ends)
    seq_mask = _range_mask(len(window), offsets[:, 1], offsets[:, 2] - 1)
    qual_mask = _range_mask(len(window), offsets[:, 3], offsets[:, 4])
    seq[:] = window[seq_mask]
    qual[:] = window[qual_mask]
    return seq, qual, ends


def gather_ids(window: np.ndarray, offsets: np.ndarray):
    """Gather whitespace-stripped id bytes + cumulative ends."""
    nrec = len(offsets)
    ends = np.empty(nrec, dtype=np.int64)
    if nrec == 0:
        return np.empty(0, dtype=np.uint8), ends
    lib = _load()
    if lib is not None:
        cap = int((offsets[:, 1] - offsets[:, 0] - 2).clip(min=0).sum())
        out = np.empty(max(cap, 1), dtype=np.uint8)
        offs = np.ascontiguousarray(offsets, dtype=np.int64)
        total = lib.bs_gather_ids(
            _ptr_u8(window), _ptr_i64(offs), nrec, _ptr_u8(out), _ptr_i64(ends)
        )
        return out[:total], ends
    buf = window.tobytes()
    parts = []
    total = 0
    for i in range(nrec):
        h, s = int(offsets[i, 0]), int(offsets[i, 1])
        part = buf[h + 1 : s - 1].strip(b" \t\n\v\f\r\x1c\x1d\x1e")
        parts.append(part)
        total += len(part)
        ends[i] = total
    return np.frombuffer(b"".join(parts), dtype=np.uint8).copy(), ends


def generate_fastq(first_read: int, num_reads: int, total_reads: int,
                   min_length: int, max_length: int, min_phred: int,
                   max_phred: int, offset: int, lower: int, upper: int,
                   base_lut: np.ndarray):
    """Native synthetic FASTQ generation; returns uint8 array or None when the
    native library is unavailable (caller falls back to numpy)."""
    lib = _load()
    if lib is None:
        return None
    num_digits = len(str(total_reads - 1)) if total_reads > 1 else 1
    cap = num_reads * (7 + num_digits + 2 * max_length + 4) + 16
    out = np.empty(cap, dtype=np.uint8)
    lut = np.ascontiguousarray(base_lut, dtype=np.uint8)
    n = lib.bs_generate_fastq(
        first_read, num_reads, total_reads, min_length, max_length,
        min_phred, max_phred, offset, lower, upper, _ptr_u8(lut), _ptr_u8(out))
    return out[:n]


def scan_gather_padded(window: np.ndarray, start: int, max_records: int,
                       width: int, check_ascii: bool, check_quality: bool,
                       q_lower: int, q_upper: int, max_rec_size: int,
                       out_seq: np.ndarray, out_qual: np.ndarray,
                       out_len: np.ndarray):
    """Fused single-pass scan+validate+padded-gather. Returns
    (count, consumed, err_code, err_phase); err_code -9 = capacity exceeded,
    other codes as bs_scan_fastq but with nothing of the bad record consumed.
    Returns None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    fm = _fast_scan()
    if fm is not None:
        try:
            return fm.scan_gather_padded(
                window, start, max_records, width, check_ascii,
                check_quality, q_lower, q_upper, max_rec_size, out_seq,
                out_qual, out_len)
        except BufferError:
            pass  # non-contiguous buffer: ctypes path below
    consumed = ctypes.c_int64(0)
    err_code = ctypes.c_int32(0)
    err_phase = ctypes.c_int32(0)
    count = lib.bs_scan_gather_padded(
        _ptr_u8(window), len(window), start, max_records, width,
        1 if check_ascii else 0, 1 if check_quality else 0,
        q_lower, q_upper - q_lower, max_rec_size,
        _ptr_u8(out_seq), _ptr_u8(out_qual),
        out_len.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.byref(consumed), ctypes.byref(err_code), ctypes.byref(err_phase))
    return count, consumed.value, err_code.value, err_phase.value


class FastaScanResult(NamedTuple):
    ids: np.ndarray  # u8 concatenated (whitespace-stripped)
    id_ends: np.ndarray  # i64 cumulative
    seqs: np.ndarray  # u8 concatenated (newlines/whitespace-normalized)
    seq_ends: np.ndarray  # i64 cumulative
    consumed: int
    lines_consumed: int
    err_code: int  # 0 OK; 100 header missing; 101 empty sequence; 4 ascii
    err_line: int  # 0-based line index within this scan


_POSIX_WS = b" \t\n\v\f\r\x1c\x1d\x1e"


def scan_fasta(window: np.ndarray, start: int = 0, at_eof: bool = False,
               max_records: int = 2**62,
               check_ascii: bool = False) -> FastaScanResult:
    """Scan window[start:] for complete FASTA records (semantics: C++
    bs_scan_fasta; reference blazeseq/fasta/parser.mojo:120-195)."""
    n = len(window)
    lib = _load()
    if lib is not None:
        span = n - start
        cap = min(max_records, span // 2 + 2)
        id_out = np.empty(max(span, 1), dtype=np.uint8)
        seq_out = np.empty(max(span, 1), dtype=np.uint8)
        id_ends = np.empty(cap + 1, dtype=np.int64)
        seq_ends = np.empty(cap + 1, dtype=np.int64)
        consumed = ctypes.c_int64(0)
        lines = ctypes.c_int64(0)
        err_code = ctypes.c_int32(0)
        err_line = ctypes.c_int64(0)
        count = lib.bs_scan_fasta(
            _ptr_u8(window), n, start, 1 if at_eof else 0, cap,
            1 if check_ascii else 0,
            _ptr_u8(id_out), _ptr_i64(id_ends), _ptr_u8(seq_out),
            _ptr_i64(seq_ends), ctypes.byref(consumed), ctypes.byref(lines),
            ctypes.byref(err_code), ctypes.byref(err_line))
        id_total = int(id_ends[count - 1]) if count else 0
        seq_total = int(seq_ends[count - 1]) if count else 0
        return FastaScanResult(
            id_out[:id_total], id_ends[:count], seq_out[:seq_total],
            seq_ends[:count], consumed.value, lines.value, err_code.value,
            err_line.value)
    return _scan_fasta_py(window, start, at_eof, max_records, check_ascii)


def count_fasta(window: np.ndarray, start: int = 0, at_eof: bool = False):
    """Count (records, bases, consumed, lines) of complete FASTA records in
    window[start:] without materializing ids/sequences (semantics:
    bs_count_fasta). Returns None when the native fast path is unavailable
    or cannot prove its accounting equals the parser's (pathological
    whitespace, content before a header, empty sequences) — callers fall
    back to the exact scan_fasta path."""
    lib = _load()
    if lib is None:
        return None
    bases = ctypes.c_int64(0)
    consumed = ctypes.c_int64(0)
    lines = ctypes.c_int64(0)
    fb = ctypes.c_int32(0)
    records = lib.bs_count_fasta(
        _ptr_u8(window), len(window), start, 1 if at_eof else 0,
        ctypes.byref(bases), ctypes.byref(consumed), ctypes.byref(lines),
        ctypes.byref(fb))
    if fb.value:
        return None
    return records, bases.value, consumed.value, lines.value


def _scan_fasta_py(window: np.ndarray, start: int, at_eof: bool,
                   max_records: int, check_ascii: bool) -> FastaScanResult:
    """Pure-Python fallback with identical semantics."""
    data = window.tobytes()[start:]
    ids, seqs = [], []
    id_ends, seq_ends = [], []
    id_total = seq_total = 0
    consumed = start
    lines_consumed = 0
    err_code, err_line = 0, 0
    have_header = False
    cur_id = b""
    cur_seq = []
    header_line = 0
    pos = 0
    line_idx = 0

    def commit():
        nonlocal id_total, seq_total, err_code, err_line
        seq = b"".join(cur_seq)
        if not seq:
            err_code, err_line = 101, header_line + 1
            return False
        if check_ascii and not (cur_id.isascii() and seq.isascii()):
            err_code, err_line = 4, header_line
            return False
        ids.append(cur_id)
        seqs.append(seq)
        id_total += len(cur_id)
        seq_total += len(seq)
        id_ends.append(id_total)
        seq_ends.append(seq_total)
        return True

    n = len(data)
    while pos < n and len(id_ends) < max_records:
        eol = data.find(b"\n", pos)
        if eol < 0:
            if not at_eof:
                break
            eol = n
        stripped = data[pos:eol].strip(_POSIX_WS)
        if not have_header:
            if not stripped:
                pos = eol + 1
                line_idx += 1
                if eol < n:
                    consumed = start + pos
                    lines_consumed = line_idx
                continue
            if not stripped.startswith(b">"):
                err_code, err_line = 100, line_idx
                break
            cur_id = stripped[1:].strip(_POSIX_WS)
            cur_seq = []
            have_header = True
            header_line = line_idx
        elif stripped.startswith(b">"):
            if not commit():
                break
            consumed = start + pos
            lines_consumed = line_idx
            cur_id = stripped[1:].strip(_POSIX_WS)
            cur_seq = []
            header_line = line_idx
        else:
            cur_seq.append(stripped)
        pos = eol + 1
        line_idx += 1
        if eol == n:
            break
    else:
        pass
    if (at_eof and have_header and not err_code and len(id_ends) < max_records
            and pos >= n):
        if commit():
            consumed = len(window)
            lines_consumed = line_idx
    ids_b = b"".join(ids)
    seqs_b = b"".join(seqs)
    return FastaScanResult(
        np.frombuffer(ids_b, dtype=np.uint8).copy(),
        np.array(id_ends, dtype=np.int64),
        np.frombuffer(seqs_b, dtype=np.uint8).copy(),
        np.array(seq_ends, dtype=np.int64),
        consumed, lines_consumed, err_code, err_line)


def scan_gather_soa(window: np.ndarray, start: int, max_records: int,
                    check_ascii: bool, check_quality: bool,
                    q_lower: int, q_upper: int,
                    seq_out: np.ndarray, qual_out: np.ndarray,
                    ends_out: np.ndarray, id_out: np.ndarray,
                    id_ends_out: np.ndarray):
    """Fused single-pass scan + validate + flat-SoA gather (batch mode).
    Returns (count, total, id_total, consumed, err_code, err_phase) or None
    when unavailable. err_code -8 = output buffers full (continue from
    consumed with fresh buffers); -9 = fall back to the offsets path for
    this region (ASCII pre-filter tripped / no AVX512)."""
    lib = _load()
    if lib is None:
        return None
    fm = _fast_scan()
    if fm is not None:
        try:
            return fm.scan_gather_soa(
                window, start, max_records, check_ascii, check_quality,
                q_lower, q_upper, seq_out, qual_out, ends_out, id_out,
                id_ends_out)
        except BufferError:
            pass  # non-contiguous buffer: ctypes path below
    total = ctypes.c_int64(0)
    id_total = ctypes.c_int64(0)
    consumed = ctypes.c_int64(0)
    err_code = ctypes.c_int32(0)
    err_phase = ctypes.c_int32(0)
    count = lib.bs_scan_gather_soa(
        _ptr_u8(window), len(window), start, max_records,
        len(seq_out), len(id_out),
        1 if check_ascii else 0, 1 if check_quality else 0,
        q_lower, q_upper - q_lower,
        _ptr_u8(seq_out), _ptr_u8(qual_out), _ptr_i64(ends_out),
        _ptr_u8(id_out), _ptr_i64(id_ends_out),
        ctypes.byref(total), ctypes.byref(id_total), ctypes.byref(consumed),
        ctypes.byref(err_code), ctypes.byref(err_phase))
    return (count, total.value, id_total.value, consumed.value,
            err_code.value, err_phase.value)


def gather_padded(window: np.ndarray, offsets: np.ndarray, width: int,
                  pad_records_to: int = 0, out=None):
    """Gather records directly into padded [rows, width] uint8 layout
    (+ clamped lengths i32[rows]). Rows beyond len(offsets) are zeroed.
    Pass out=(seq, qual, lengths) (contiguous views) to fill preallocated
    buffers."""
    nrec = len(offsets)
    if out is not None:
        seq, qual, lengths = out
    else:
        rows = max(nrec, pad_records_to)
        seq = np.zeros((rows, width), dtype=np.uint8)
        qual = np.zeros((rows, width), dtype=np.uint8)
        lengths = np.zeros(rows, dtype=np.int32)
    if nrec == 0:
        return seq, qual, lengths
    lib = _load()
    if lib is not None:
        offs = np.ascontiguousarray(offsets, dtype=np.int64)
        lib.bs_gather_padded(
            _ptr_u8(window), _ptr_i64(offs), nrec, width,
            _ptr_u8(seq), _ptr_u8(qual),
            lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return seq, qual, lengths
    true_lens = offsets[:, 2] - offsets[:, 1] - 1
    lens = np.minimum(true_lens, width)
    # the quality copy stops at the record's end (a last record without its
    # newline may have a short quality line), as in bs_gather_padded
    qlens = np.clip(np.minimum(offsets[:, 4] - offsets[:, 3], lens), 0, None)
    for i in range(nrec):
        s, q, L = int(offsets[i, 1]), int(offsets[i, 3]), int(lens[i])
        QL = int(qlens[i])
        seq[i, :L] = window[s : s + L]
        qual[i, :QL] = window[q : q + QL]
        # zero the row padding explicitly: `out=` buffers (reuse pools) carry
        # stale bytes from the previous batch
        seq[i, L:] = 0
        qual[i, QL:] = 0
    lengths[:nrec] = true_lens
    return seq, qual, lengths


def pad_rows(seq: np.ndarray, qual: np.ndarray, ends: np.ndarray,
             width: int, rows: int):
    """Rows of a flat SoA batch (record i is [ends[i-1], ends[i]) of `seq`
    and `qual`) in the padded layout: (seq u8[rows, width], qual
    u8[rows, width], lengths i32[rows]). A row holds the first
    min(len, width) bytes of its record and zeros after them; rows past
    len(ends) are zero. Lengths are the true ones, not clamped (unlike
    gather_padded). One memcpy a row in C++; `_pad_rows_np` without the
    library."""
    seq = np.ascontiguousarray(seq, np.uint8)
    qual = np.ascontiguousarray(qual, np.uint8)
    ends = np.ascontiguousarray(ends, np.int64)
    n = len(ends)
    if rows < n or width < 0:
        raise ValueError("pad_rows: %d rows of width %d for %d records"
                         % (rows, width, n))
    if n and (ends[0] < 0 or (np.diff(ends) < 0).any()
              or ends[-1] > min(len(seq), len(qual))):
        raise ValueError("pad_rows: record ends must be nondecreasing, "
                         "within seq and qual")
    lib = _load()
    if lib is None:
        return _pad_rows_np(seq, qual, ends, width, rows)
    seq2d = np.empty((rows, width), np.uint8)
    qual2d = np.empty((rows, width), np.uint8)
    lengths = np.empty(rows, np.int32)
    lib.bs_pad_rows(_ptr_u8(seq), _ptr_u8(qual), _ptr_i64(ends), n, width,
                    rows, _ptr_u8(seq2d), _ptr_u8(qual2d),
                    lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return seq2d, qual2d, lengths


def _pad_rows_np(seq, qual, ends, width, rows):
    """numpy form of `pad_rows`: row indices by np.repeat, then one flat
    scatter a column array."""
    n = len(ends)
    seq2d = np.zeros((rows, width), np.uint8)
    qual2d = np.zeros((rows, width), np.uint8)
    lengths = np.zeros(rows, np.int32)
    if n:
        starts = np.concatenate(([0], ends[:-1]))
        lens = ends - starts
        keep = np.minimum(lens, width)
        first = np.cumsum(keep) - keep  # where each row's bytes begin
        col = np.arange(int(keep.sum()), dtype=np.int64) - np.repeat(first,
                                                                     keep)
        src = np.repeat(starts, keep) + col
        dst = np.repeat(np.arange(n, dtype=np.int64) * width, keep) + col
        seq2d.reshape(-1)[dst] = seq[src]
        qual2d.reshape(-1)[dst] = qual[src]
        lengths[:n] = lens.astype(np.int32)
    return seq2d, qual2d, lengths


def _range_mask(n: int, starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """Boolean mask covering [starts_i, ends_i) ranges; O(n) vectorized."""
    delta = np.zeros(n + 1, dtype=np.int32)
    np.add.at(delta, starts, 1)
    np.add.at(delta, ends, -1)
    return np.cumsum(delta[:-1]) > 0


def find_newlines(window: np.ndarray, start: int = 0) -> np.ndarray:
    lib = _load()
    n = len(window)
    if lib is not None and n - start > 0:
        cap = n - start
        out = np.empty(cap, dtype=np.int64)
        cnt = lib.bs_find_newlines(
            _ptr_u8(window[start:]) if start else _ptr_u8(window),
            n - start, _ptr_i64(out), cap,
        )
        res = out[:cnt]
        return res + start if start else res
    return np.flatnonzero(window[start:] == 10).astype(np.int64) + start


def serialize_fastq(ids, id_starts, id_lens, seq, qual, offs,
                    lens) -> bytes:
    """Bulk '@id\\nseq\\n+\\nqual\\n' serialization of per-record spans
    (the write-side complement of the bulk scan): seq/qual spans are
    (offs[i], lens[i]) into the shared arrays; records with lens[i] <= 0
    are dropped. C kernel; bytes-join fallback with identical output."""
    ids = np.ascontiguousarray(ids, np.uint8)
    seq = np.ascontiguousarray(seq, np.uint8)
    qual = np.ascontiguousarray(qual, np.uint8)
    id_starts = np.ascontiguousarray(id_starts, np.int64)
    id_lens = np.ascontiguousarray(id_lens, np.int64)
    offs = np.ascontiguousarray(offs, np.int64)
    lens = np.ascontiguousarray(lens, np.int64)
    n = len(lens)
    # per record: '@'(1) id '\n'(1) seq '\n+\n'(3) qual '\n'(1)
    total = int(np.where(lens > 0, 6 + id_lens + 2 * lens, 0).sum())
    lib = _load()
    if lib is not None:
        p_u8 = ctypes.POINTER(ctypes.c_uint8)
        p_i64 = ctypes.POINTER(ctypes.c_int64)
        out = np.empty(max(total, 1), np.uint8)
        w = lib.bs_serialize_fastq(
            ids.ctypes.data_as(p_u8), id_starts.ctypes.data_as(p_i64),
            id_lens.ctypes.data_as(p_i64), seq.ctypes.data_as(p_u8),
            qual.ctypes.data_as(p_u8), offs.ctypes.data_as(p_i64),
            lens.ctypes.data_as(p_i64), n, out.ctypes.data_as(p_u8),
            total)
        if w == total:
            return out[:total].tobytes()
    mv_i = memoryview(ids)
    mv_s = memoryview(seq)
    mv_q = memoryview(qual)
    parts = []
    for k in range(n):
        ln = int(lens[k])
        if ln <= 0:
            continue
        a = int(offs[k])
        ia = int(id_starts[k])
        il = int(id_lens[k])
        parts.append(b"@%s\n%s\n+\n%s\n" % (
            mv_i[ia:ia + il].tobytes(), mv_s[a:a + ln].tobytes(),
            mv_q[a:a + ln].tobytes()))
    return b"".join(parts)
