"""Barcode demultiplexing (counterpart of blazeseq_tpu/ops/demux.py).

Each read of a padded batch goes to the barcode with the fewest mismatches
over its 5' prefix when exactly one barcode is within `max_mismatches`;
ties and misses give -1 (unassigned). 'N' in a BARCODE matches any base;
reads are upper-cased with `& 0xDF`, and 'N' in a read mismatches every
barcode base but 'N'. A read shorter than the barcode never matches.

`demux_assign` dispatches on the reads' device: CUDA tensors run one launch
of the hand-written kernel in csrc/demux.cu (counted in
`demux_assign.launches`; the barcode set is uploaded once a set and
device, as bit-planes of base codes or, for a small set, a set with a
byte outside ACGTN or barcodes over 256 bases, as bytes; any set the
plain version takes) or the call raises; CPU tensors run the plain torch
version `demux_assign_torch` ([n, K, bl] compares).

Host twin: `demux_assign_host` (pure Python).
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .. import _kernels
from .common import check_cuda_batch, resolve_device

N_BYTE = ord("N")


def _prep_barcodes(barcodes: Sequence[bytes]):
    bl = len(barcodes[0])
    if any(len(b) != bl for b in barcodes):
        raise ValueError("all barcodes must share one length")
    arr = np.frombuffer(b"".join(bytes(b).upper() for b in barcodes),
                        dtype=np.uint8).reshape(len(barcodes), bl)
    return arr, bl


def demux_assign_torch(seq, lengths, barcodes: Sequence[bytes],
                       max_mismatches: int = 1
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of `demux_assign`."""
    codes_np, bl = _prep_barcodes(barcodes)
    seq = torch.as_tensor(seq)
    if seq.shape[1] < bl:
        raise ValueError("reads narrower than the barcode length")
    lengths = torch.as_tensor(lengths, device=seq.device)
    codes = torch.from_numpy(codes_np.copy()).to(seq.device)
    up = seq[:, :bl] & 0xDF
    mism = (up[:, None, :] != codes[None]) & (codes[None] != N_BYTE)
    mm = mism.sum(2, dtype=torch.int32)  # [n, K]
    mm = torch.where(lengths[:, None] < bl, bl + 1, mm)
    best, best_k = mm.min(1)
    n_best = (mm == best[:, None]).sum(1)
    ok = (best <= int(max_mismatches)) & (n_best == 1)
    return (torch.where(ok, best_k, -1).to(torch.int32),
            best.to(torch.int32))


# sets of up to 2^20 barcodes of up to 256 bases, every byte one of ACGTN,
# take the planes layout of csrc/demux.cu (a read's planes in registers, a
# barcode's index in 20 bits of a key), but for sets of at most 8 barcodes
# of at most 16 bases (such as the CLI's 4 x 8), which the bytes layout
# holds in registers with no plane to build; any other set takes bytes
_MAX_PLANES_LEN = 256
_MAX_PLANES_SET = 1 << 20
_MAX_DIRECT_SET, _MAX_DIRECT_LEN = 8, 16


def _pack_set(codes, planes):
    """The set's words in one layout (numpy, int32). planes: [K, ceil(bl /
    32), 4], for 32 positions at a time the bit-planes 0, 1 and 2 of each
    base's code (b >> 1) & 7, then a mask of the positions that hold a base
    other than 'N'. bytes: [2, K, ceil(bl / 4)], the upper-cased bytes four
    a word, then a mask word with 0xFF in each byte of a base other than
    'N'."""
    K, bl = codes.shape
    care = codes != N_BYTE
    if planes:
        W = -(-bl // 32)
        bits = np.zeros((4, K, 32 * W), np.uint64)
        c = (codes >> 1) & 7
        for p in range(3):
            bits[p, :, :bl] = (c >> p) & 1
        bits[3, :, :bl] = care
        words = (bits.reshape(4, K, W, 32)
                 << np.arange(32, dtype=np.uint64)).sum(-1)
        words = words.astype(np.uint32).transpose(1, 2, 0)
        return np.ascontiguousarray(words).view(np.int32)
    W = -(-bl // 4)
    padded = np.zeros((2, K, 4 * W), np.uint8)
    padded[0, :, :bl] = codes
    padded[1, :, :bl] = np.where(care, 0xFF, 0)
    return padded.view(np.int32).copy()


@functools.lru_cache(maxsize=64)
def _barcode_words(barcodes: Tuple[bytes, ...], device: torch.device):
    """The set as csrc/demux.cu reads it, on `device`, made once a set and
    device: (planes, words) in the layout of `_pack_set`, the planes for bl
    <= 256, K <= 2^20 and every upper-cased byte one of ACGTN, but not for
    K <= 8 with bl <= 16; else the bytes."""
    codes, bl = _prep_barcodes(barcodes)
    K = len(barcodes)
    planes = bool(
        bl <= _MAX_PLANES_LEN and K <= _MAX_PLANES_SET
        and not (K <= _MAX_DIRECT_SET and bl <= _MAX_DIRECT_LEN)
        and np.isin(codes, np.frombuffer(b"ACGTN", np.uint8)).all())
    return planes, torch.from_numpy(_pack_set(codes, planes)).to(device)


def _launch(seq, lengths, planes, words, K, bl, max_mismatches):
    """One launch of csrc/demux.cu on a set in the layout `planes`."""
    lengths = torch.as_tensor(lengths).to(torch.int32)
    check_cuda_batch("demux_assign", [("seq", seq)], [("lengths", lengths)])
    n, L = seq.shape
    if L < bl:
        raise ValueError("reads narrower than the barcode length")
    # every best is in [0, bl + 1]: a bound past that range acts as its end
    max_mm = min(max(int(max_mismatches), -1), bl + 1)
    out = torch.empty((2, n), dtype=torch.int32, device=seq.device)
    if n:
        lib = _kernels.load()
        dev = seq.device
        with _kernels.on_device(dev):
            err = lib.bs_demux_assign(
                seq.data_ptr(), lengths.data_ptr(), words.data_ptr(),
                out[0].data_ptr(), out[1].data_ptr(), n, L, K, bl, max_mm,
                int(planes), _kernels.stream_ptr(dev))
        _kernels.check(err, "bs_demux_assign")
        demux_assign.launches += 1
    return out[0], out[1]


def _demux_assign_cuda(seq, lengths, barcodes, max_mismatches):
    barcodes = tuple(bytes(b) for b in barcodes)
    planes, words = _barcode_words(barcodes, seq.device)
    return _launch(seq, lengths, planes, words, len(barcodes),
                   len(barcodes[0]), max_mismatches)


def demux_assign(seq, lengths, barcodes: Sequence[bytes],
                 max_mismatches: int = 1
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Assign padded reads [n, L] (a tensor, or an array taken on the CPU)
    to barcodes, on the reads' device.

    Returns (assignments i32[n] with -1 = unassigned/ambiguous,
    best_mismatches i32[n]). CPU tensors run `demux_assign_torch`; CUDA
    tensors run the kernel (counted in `demux_assign.launches`) or
    raise."""
    seq = torch.as_tensor(seq)
    if seq.is_cuda:
        return _demux_assign_cuda(seq, lengths, barcodes, max_mismatches)
    if seq.device.type != "cpu":
        raise ValueError("demux_assign: unsupported device %s" % seq.device)
    return demux_assign_torch(seq, lengths, barcodes, max_mismatches)


demux_assign.launches = 0


def demux_assign_host(seqs: List[bytes], barcodes: Sequence[bytes],
                      max_mismatches: int = 1) -> List[int]:
    """Scalar host twin with identical semantics (validation reference)."""
    out = []
    bl = len(barcodes[0])
    codes = [bytes(b).upper() for b in barcodes]
    for s in seqs:
        s = bytes(s).upper()
        if len(s) < bl:
            out.append(-1)
            continue
        mms = []
        for c in codes:
            mm = sum(1 for x, y in zip(s[:bl], c)
                     if y != N_BYTE and x != y)
            mms.append(mm)
        best = min(mms)
        if best <= max_mismatches and mms.count(best) == 1:
            out.append(mms.index(best))
        else:
            out.append(-1)
    return out


def demultiplex_counts(assignments, n_barcodes: int) -> torch.Tensor:
    """Per-sample read counts i32[n_barcodes + 1]: samples in order, then
    unassigned last."""
    a = torch.as_tensor(assignments)
    bins = torch.arange(-1, n_barcodes, dtype=a.dtype, device=a.device)
    counts = (a[:, None] == bins[None, :]).sum(0, dtype=torch.int32)
    return torch.cat([counts[1:], counts[:1]])


def demultiplex_to_writers(parser, barcodes: Sequence[bytes], writers,
                           unassigned_writer=None, max_mismatches: int = 1,
                           batch_records: int = 16384, max_len: int = 256,
                           trim_barcode: bool = False, device="cuda"):
    """Stream a FASTQ parser through assignment on `device` ("cuda" needs a
    card and raises without one; "cpu" by name) and write each read to its
    sample's writer, in batch order. Returns the per-sample counts list
    (+ unassigned last)."""
    if len(writers) != len(barcodes):
        raise ValueError("one writer per barcode required")
    from .. import native
    from ..fastq.batch import padded_to_device

    dev = resolve_device(device, "demultiplex_to_writers")
    _, bl = _prep_barcodes(barcodes)
    totals = [0] * (len(barcodes) + 1)
    for batch in parser.batches(batch_records):
        pb = padded_to_device(batch.to_padded(max_len=max_len), dev)
        assign, _ = demux_assign(pb.seq, pb.lengths, barcodes,
                                 max_mismatches)
        a = assign.cpu().numpy()[: pb.n_records]
        batch._finalize()
        ends = batch._ends
        starts = np.concatenate(([0], ends[:-1]))
        lens = ends - starts
        id_ends = batch._id_ends
        id_starts = np.concatenate(([0], id_ends[:-1]))
        id_lens = id_ends - id_starts
        # one bulk serialisation per sample; the masks keep batch order
        for k in range(-1, len(barcodes)):
            m = a == k
            cnt = int(m.sum())
            if cnt == 0:
                continue
            totals[k] += cnt  # k == -1 lands on the unassigned slot
            w = unassigned_writer if k < 0 else writers[k]
            if w is None:
                continue
            offs_k = starts[m]
            lens_k = lens[m]
            if k >= 0 and trim_barcode:
                offs_k = offs_k + bl
                lens_k = np.maximum(lens_k - bl, 0)
                if (lens_k == 0).any():
                    # a read exactly the barcode's length trims to an empty
                    # record, which the bulk serialiser drops: write
                    # "@id\n\n+\n\n" as the reference does
                    from ..fastq.record import FastqRecord

                    for i in np.flatnonzero(m):
                        rec = batch.get_record(int(i))
                        FastqRecord(rec.id_bytes(),
                                    rec.sequence_bytes()[bl:],
                                    rec.quality_bytes()[bl:],
                                    phred_offset=rec._phred_offset).write(w)
                    continue
            w.write_bytes(native.serialize_fastq(
                batch._id_bytes, id_starts[m], id_lens[m],
                batch._sequence_bytes, batch._quality_bytes,
                offs_k, lens_k))
    return totals
