"""Build and load the port's hand-written CUDA kernels.

The sources under ``csrc/`` have a plain C interface and no PyTorch headers.
At first use each is compiled with its own ``nvcc``, all started together,
and the objects are linked into one shared library under ``_build/<hash>/``
(the hash covers the sources and the flags, so an edited source rebuilds),
which is loaded with ctypes. Nothing is built at import time:
the CPU path never needs a compiler.

Each entry point takes device pointers and the CUDA stream as ``c_void_p``
and returns ``cudaGetLastError()`` after its launch; ``check`` raises on a
nonzero return.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
SOURCES = ("validate.cu", "uniform_qc.cu", "nw.cu", "scan.cu",
           "ragged_qc.cu", "qc_stats.cu", "adapter.cu", "dedup.cu",
           "parse.cu", "merge.cu", "trim.cu", "demux.cu", "tiles.cu",
           "kmer.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
LIB_NAME = "libblazeseq_kernels.so"
# dynamic shared memory one block may use on sm_90
MAX_SMEM = 232448

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    # seq, qual, lengths, codes, phred, n, L, col_offset, q_lo, q_hi,
    # offset, check_ascii, check_quality, group, max_blocks, stream
    "bs_validate_decode": (_P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _I, _I,
                           _I, _I, _I, _P),
    # chunk, nrec_valid, rs, o1, o2, o3, cnt, q_lo, q_hi, offset,
    # check_ascii, check_quality, bad, csq, csb, qh, gch, mqh, sm_count,
    # stream
    "bs_uniform_qc": (_P, _LL, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P,
                      _P, _P, _P, _P, _P, _I, _P),
    # rs, cnt
    "bs_uniform_qc_smem_bytes": (_I, _I),
    # rs
    "bs_uniform_qc_tile_rows": (_I,),
    # seq, lengths, ref, scores, B, Lq, Lr, stream
    "bs_nw_scores": (_P, _P, _P, _P, _LL, _I, _I, _P),
    "bs_nw_smem_bytes": (_I, _I),
    # seq, lengths, ref, scores, B, Lq, Lr, mode, match, mismatch, gap,
    # gap_open, gap_extend, stream
    "bs_nw_variant_scores": (_P, _P, _P, _P, _LL, _I, _I, _I, _I, _I, _I,
                             _I, _I, _P),
    # Lq, Lr, mode
    "bs_nw_variant_smem_bytes": (_I, _I, _I),
    # chunk, nl, at, plus, counts, rows, max_blocks, stream
    "bs_structural_bitmaps": (_P, _P, _P, _P, _P, _LL, _I, _P),
    # chunk, status, n_valid, tile, width, q_lo, q_hi, offset, check_ascii,
    # check_quality, out, sm_count, stream
    "bs_ragged_qc": (_P, _P, _LL, _I, _I, _I, _I, _I, _I, _I, _P, _I, _P),
    # width
    "bs_ragged_qc_blocks_per_sm": (_I,),
    # seq, qual, lengths, codes, out, n, n_valid, L, col_offset, offset,
    # reads, count_scalars, row_stats, qual_hist_2d, group, rows_per_block,
    # cluster, stream
    "bs_qc_stats": (_P, _P, _P, _P, _P, _LL, _LL, _I, _I, _I, _I, _I, _I, _I,
                    _I, _I, _I, _P),
    # seq, lengths, ad, ad_off, meta, out, n_valid, L, n_ad, ad_bytes,
    # la_max, reads_scanned, stream
    "bs_adapter_contents": (_P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _I,
                            _P),
    # seq, lengths, out, n, n_valid, rows, L, sm_count, stream
    "bs_read_hashes": (_P, _P, _P, _LL, _LL, _LL, _I, _I, _P),
    # chunk, n, q_lo, q_hi, offset, max_phred, ints, flags, scratch, tiles,
    # sm_count, stream
    "bs_raw_stream_qc": (_P, _LL, _I, _I, _I, _I, _P, _P, _P, _LL, _I, _P),
    # chunk, n, start, max_count, pos, scratch, tiles, max_blocks, stream
    "bs_newline_positions": (_P, _LL, _LL, _LL, _P, _P, _LL, _I, _P),
    # chunk, n, start, max_records, offsets, codes, scratch, tiles,
    # max_blocks, stream
    "bs_record_offsets": (_P, _LL, _I, _LL, _P, _P, _P, _LL, _I, _P),
    # chunk, n, offsets, max_records, max_len, seq, qual, lengths, stream
    "bs_gather_padded": (_P, _LL, _P, _LL, _I, _P, _P, _P, _P),
    # counts, rows, tail, tail_len, work, out, max_blocks, stream
    "bs_count_records": (_P, _LL, _P, _I, _P, _P, _I, _P),
    # seq1, qual1, len1, seq2, qual2, len2, ints, seq, qual, n, L,
    # min_overlap, mismatch_penalty, max_mismatch_frac, stream
    "bs_merge_pairs": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _I,
                       _F, _P),
    # qual, lengths, out0, out1, n, L, mode, offset, a, b, window, stream
    "bs_trim": (_P, _P, _P, _P, _LL, _I, _I, _I, _I, _I, _I, _P),
    # seq, lengths, words, assign, best, n, L, K, bl, max_mm, planes,
    # stream
    "bs_demux_assign": (_P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _I, _P),
    # qual, lengths, dst, out, sums, tickets, n, L, T, offset, max_phred,
    # sm_count, stream
    "bs_tile_sums": (_P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _I, _P),
    # seq, lengths, n_valid_ptr, n_valid_bytes, n_valid, out, state, n, L,
    # k, sm_count, stream
    "bs_kmer_counts": (_P, _P, _P, _I, _LL, _P, _P, _LL, _I, _I, _I, _P),
}


def find_nvcc() -> str:
    """nvcc on PATH, else under $CUDA_HOME/bin (or the CUDA home PyTorch
    itself detects)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME")
    if not home:
        from torch.utils.cpp_extension import CUDA_HOME

        home = CUDA_HOME
    cand = os.path.join(home, "bin", "nvcc") if home else None
    if cand and os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin; the CUDA kernels "
        "of blazeseq_tpu_torch cannot be built")


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _run_all(cmds) -> None:
    """Run the commands concurrently; raise with the stderr of the first
    that fails, after all have ended."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in cmds]
    failed = None
    for cmd, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0 and failed is None:
            failed = (cmd, proc.returncode, err)
    if failed is not None:
        cmd, rc, err = failed
        raise RuntimeError("nvcc failed (exit %d): %s\n%s"
                           % (rc, " ".join(cmd), err))


def build() -> str:
    """Compile the sources into ``_build/<hash>/`` unless already there;
    returns the library path. Raises with nvcc's stderr on failure."""
    out_dir = os.path.join(BUILD_DIR, _source_hash())
    lib_path = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    nvcc = find_nvcc()
    # objects and library under temporary names, then a rename: a
    # concurrent loader never sees a half-written library
    work = tempfile.mkdtemp(dir=out_dir)
    try:
        objs = [os.path.join(work, s + ".o") for s in SOURCES]
        _run_all([nvcc, *NVCC_FLAGS, "-c", "-o", o, os.path.join(CSRC, s)]
                 for s, o in zip(SOURCES, objs))
        tmp = os.path.join(work, LIB_NAME)
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]])
        os.replace(tmp, lib_path)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib_path


@functools.cache
def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every entry
    point's argument types declared."""
    lib = ctypes.CDLL(build())
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError("%s: CUDA error %d at launch" % (what, err))


@functools.cache
def sm_count(device_index: int) -> int:
    import torch

    return torch.cuda.get_device_properties(device_index).multi_processor_count


def stream_ptr(device) -> int:
    """The raw handle of PyTorch's current stream on `device` (a CUDA
    torch.device), without building a Stream object."""
    import torch

    return torch._C._cuda_getCurrentRawStream(device.index)


def on_device(device):
    """A context that makes `device` current for a launch: nothing when it
    already is, else torch.cuda.device(device)."""
    import torch

    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)
