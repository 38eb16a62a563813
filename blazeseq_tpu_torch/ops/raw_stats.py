"""Raw-stream QC: global statistics straight from FASTQ bytes on the device
(counterpart of blazeseq_tpu/ops/raw_stats.py, which is XLA code).

Every byte's role follows from its line phase, the number of newlines
before it mod 4 (0 header, 1 sequence, 2 separator, 3 quality, for a
stream that starts at a record boundary). One running newline count and
masked reductions give reads, bases, base composition, the Phred histogram
and the structure / validation flags.

Only complete records count: `tail_start` is the offset just past the last
record's final newline, so the caller re-feeds the bytes from there with the
next chunk. Counters are int32: feed chunks below 2 GB and accumulate across
chunks on the host.

`raw_stream_qc` dispatches: CPU tensors run the plain torch version
`raw_stream_qc_torch`; CUDA tensors run csrc/parse.cu (one read of the
chunk, its 16 KiB tiles ranked by a look-back, each thread's 64 bytes
judged with 64-bit phase masks; then a small pass that takes back the
trailing partial record; counted in `raw_stream_qc.launches`) or raise.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import _kernels
from .common import AT, NEWLINE, PLUS
from .scan import _chunk_len, _scratch


class RawStreamQC(NamedTuple):
    reads: torch.Tensor          # i32[] complete records
    bases: torch.Tensor          # i32[] sequence bytes in complete records
    base_counts: torch.Tensor    # i32[5] A C G T other (complete records)
    qual_hist: torch.Tensor      # i32[max_phred] Phred histogram
    bad_structure: torch.Tensor  # bool[] any '@'/'+' line-start violation
    seq_qual_mismatch: torch.Tensor  # bool[] total seq != total qual bytes
    bad_ascii: torch.Tensor      # bool[] high bit anywhere in the chunk
    bad_quality: torch.Tensor    # bool[] quality byte out of schema range
    tail_start: torch.Tensor     # i32[] offset of the trailing partial record

    def mean_q_sum(self) -> int:
        """Exact sum of decoded Phred scores, from the histogram in int64 on
        the host (an int32 sum on the device would overflow)."""
        hist = np.asarray(torch.as_tensor(self.qual_hist).cpu(), np.int64)
        return int((np.arange(len(hist), dtype=np.int64) * hist).sum())


def raw_stream_qc_torch(chunk: torch.Tensor, q_lower, q_upper, offset,
                        max_phred: int = 64) -> RawStreamQC:
    """Plain torch version of `raw_stream_qc`."""
    dev = chunk.device
    n = chunk.shape[0]
    i32 = dict(dtype=torch.int32, device=dev)
    if n == 0:
        z = torch.zeros((), **i32)
        f = torch.zeros((), dtype=torch.bool, device=dev)
        return RawStreamQC(z, z, torch.zeros(5, **i32),
                           torch.zeros(max_phred, **i32), f, f, f, f, z)
    nl = chunk == NEWLINE
    # inclusive running newline count; only its value mod 4 is used, so
    # int32 holds it for any chunk below 2 GB
    incl = torch.cumsum(nl, 0, dtype=torch.int32)
    phase = ((incl - nl.to(torch.int32)) & 3).to(torch.uint8)

    idx = torch.arange(n, **i32)
    # a newline whose inclusive count is 0 mod 4 ends a record
    rec_end = nl & ((incl & 3) == 0)
    del incl
    tail_start = torch.where(rec_end, idx + 1, 0).max()
    reads = rec_end.sum(dtype=torch.int32)
    complete = idx < tail_start
    del idx

    seq_m = (phase == 1) & ~nl & complete
    qual_m = (phase == 3) & ~nl & complete

    # base composition, case-insensitive (A C G T other)
    upper = chunk & 0xDF
    counts = [(seq_m & (upper == b)).sum(dtype=torch.int32) for b in b"ACGT"]
    bases = seq_m.sum(dtype=torch.int32)
    base_counts = torch.stack(counts + [bases - sum(counts)])

    # Phred histogram of quality bytes, offset-decoded and clamped into
    # max_phred bins; every other byte goes to a dropped extra bin
    off = int(offset) & 0xFF
    phred = torch.where(chunk < off, 0, chunk - off).clamp_(max=max_phred - 1)
    binned = torch.where(qual_m, phred.to(torch.int64), max_phred)
    qual_hist = torch.bincount(binned, minlength=max_phred + 1)[:max_phred]
    qual_hist = qual_hist.to(torch.int32)

    # a line starts at byte 0 and after every newline; phase-0 starts must
    # be '@', phase-2 starts '+'
    start_m = torch.cat([nl.new_ones(1), nl[:-1]]) & complete
    bad_at = (start_m & (phase == 0) & (chunk != AT)).any()
    bad_plus = (start_m & (phase == 2) & (chunk != PLUS)).any()
    bad_structure = bad_at | bad_plus
    seq_qual_mismatch = bases != qual_m.sum(dtype=torch.int32)

    bad_ascii = ((chunk & 0x80) != 0).any()
    lo, hi = int(q_lower) & 0xFF, int(q_upper) & 0xFF
    bad_quality = (qual_m & ((chunk < lo) | (chunk > hi))).any()

    return RawStreamQC(reads, bases, base_counts, qual_hist, bad_structure,
                       seq_qual_mismatch, bad_ascii, bad_quality,
                       tail_start.to(torch.int32))


def _raw_stream_qc_cuda(chunk, q_lower, q_upper, offset, max_phred):
    n = _chunk_len("raw_stream_qc", chunk)
    if not 1 <= max_phred <= 256:
        raise ValueError("raw_stream_qc: max_phred %d outside [1, 256]"
                         % max_phred)
    lib = _kernels.load()
    dev = chunk.device
    # reads, bases, tail_start, base_counts[5], qual_hist[max_phred]
    ints = torch.empty(8 + max_phred, dtype=torch.int32, device=dev)
    flags = torch.empty(4, dtype=torch.bool, device=dev)
    # a 64-bit status word a tile, the tile counter, the newline count,
    # the quality count, the least bad indices and a finished-block count
    tiles, scratch = _scratch(chunk, 2, 6)
    with _kernels.on_device(dev):
        err = lib.bs_raw_stream_qc(
            chunk.data_ptr(), n, int(q_lower), int(q_upper), int(offset),
            max_phred, ints.data_ptr(), flags.data_ptr(), scratch.data_ptr(),
            tiles, _kernels.sm_count(dev.index), _kernels.stream_ptr(dev))
    _kernels.check(err, "bs_raw_stream_qc")
    if n:
        raw_stream_qc.launches += 1
    return RawStreamQC(ints[0], ints[1], ints[3:8], ints[8:], flags[0],
                       flags[1], flags[2], flags[3], ints[2])


def raw_stream_qc(chunk: torch.Tensor, q_lower, q_upper, offset,
                  max_phred: int = 64) -> RawStreamQC:
    """chunk: u8[n] starting at a record boundary; q_lower / q_upper /
    offset: the quality schema's LOWER / UPPER / OFFSET (taken mod 256, as
    the reference's uint8 casts do). CPU tensors run `raw_stream_qc_torch`;
    CUDA tensors run the kernels (counted in `raw_stream_qc.launches`) or
    raise."""
    if chunk.is_cuda:
        return _raw_stream_qc_cuda(chunk, q_lower, q_upper, offset,
                                   int(max_phred))
    if chunk.device.type != "cpu":
        raise ValueError("raw_stream_qc: unsupported device %s"
                         % chunk.device)
    return raw_stream_qc_torch(chunk, q_lower, q_upper, offset, max_phred)


raw_stream_qc.launches = 0
