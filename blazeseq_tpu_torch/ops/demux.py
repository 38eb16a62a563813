"""Barcode demultiplexing (counterpart of blazeseq_tpu/ops/demux.py; torch
ops, no kernel).

Each read of a padded batch goes to the barcode with the fewest mismatches
over its 5' prefix when exactly one barcode is within `max_mismatches`;
ties and misses give -1 (unassigned). 'N' in a BARCODE matches any base;
reads are upper-cased with `& 0xDF`, and 'N' in a read mismatches every
barcode base but 'N'. A read shorter than the barcode never matches.

Host twin: `demux_assign_host` (pure Python).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from .common import resolve_device

N_BYTE = ord("N")


def _prep_barcodes(barcodes: Sequence[bytes]):
    bl = len(barcodes[0])
    if any(len(b) != bl for b in barcodes):
        raise ValueError("all barcodes must share one length")
    arr = np.frombuffer(b"".join(bytes(b).upper() for b in barcodes),
                        dtype=np.uint8).reshape(len(barcodes), bl)
    return arr, bl


def demux_assign(seq, lengths, barcodes: Sequence[bytes],
                 max_mismatches: int = 1
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Assign padded reads [n, L] (a tensor, or an array taken on the CPU)
    to barcodes, on the reads' device.

    Returns (assignments i32[n] with -1 = unassigned/ambiguous,
    best_mismatches i32[n])."""
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
    from blazeseq_tpu import native

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
                    from blazeseq_tpu.fastq.record import FastqRecord

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
