"""Fused validation + Phred decode over padded [n, L] batches (counterpart
of blazeseq_tpu/ops/validate.py).

One pass gives:

* per-record error codes (0 = OK, 4 = ASCII_INVALID, 5 =
  QUALITY_OUT_OF_RANGE; 4 overrides 5), over each record's first
  `lengths[r]` positions;
* decoded Phred scores u8[n, L]: `qual - offset` cast to u8 on in-length
  columns (it wraps when qual < offset), 0 past the length.

`validate_decode_torch` is the plain torch version. `validate_decode`
dispatches on the tensors' device: CPU tensors take the plain version, CUDA
tensors the hand-written kernel in csrc/validate.cu, or the call raises.
"""

from __future__ import annotations

import torch

from .. import _kernels
from .common import length_mask

ASCII_INVALID = 4
QUALITY_OUT_OF_RANGE = 5


def validate_decode_torch(seq, qual, lengths, q_lower: int, q_upper: int,
                          offset: int, check_ascii: bool = True,
                          check_quality: bool = True, col_offset: int = 0):
    """Plain torch version. Returns (codes int32[n], phred u8[n, L]).
    `col_offset`: the batch's starting column when it holds a column slice
    of longer records."""
    mask = length_mask(lengths, seq.shape[1], col_offset)
    q = qual.to(torch.int32)
    codes = torch.zeros(seq.shape[0], dtype=torch.int32, device=seq.device)
    if check_quality:
        bad_q = (mask & ((q < int(q_lower)) | (q > int(q_upper)))).any(1)
        codes = torch.where(bad_q, QUALITY_OUT_OF_RANGE, codes)
    if check_ascii:
        bad_a = (mask & (((seq | qual) & 0x80) != 0)).any(1)
        codes = torch.where(bad_a, ASCII_INVALID, codes)
    phred = (torch.where(mask, q - int(offset), 0) & 0xFF).to(torch.uint8)
    return codes, phred


def _check_batch(seq, qual, lengths):
    for name, t, dt in (("seq", seq, torch.uint8), ("qual", qual, torch.uint8),
                        ("lengths", lengths, torch.int32)):
        if not t.is_cuda:
            raise ValueError("validate_decode: %s is not on a CUDA device "
                             "(got %s)" % (name, t.device))
        if t.dtype != dt:
            raise TypeError("validate_decode: %s must be %s, got %s"
                            % (name, dt, t.dtype))
        if not t.is_contiguous():
            raise ValueError("validate_decode: %s must be contiguous" % name)
    if seq.dim() != 2 or qual.shape != seq.shape:
        raise ValueError("validate_decode: seq and qual must both be [n, L], "
                         "got %s and %s" % (tuple(seq.shape),
                                            tuple(qual.shape)))
    if lengths.shape != (seq.shape[0],):
        raise ValueError("validate_decode: lengths must be [n], got %s"
                         % (tuple(lengths.shape),))
    if not (seq.device == qual.device == lengths.device):
        raise ValueError("validate_decode: inputs on different devices")


def _validate_decode_cuda(seq, qual, lengths, q_lower, q_upper, offset,
                          check_ascii, check_quality, col_offset):
    _check_batch(seq, qual, lengths)
    lib = _kernels.load()
    n, L = seq.shape
    codes = torch.empty(n, dtype=torch.int32, device=seq.device)
    phred = torch.empty((n, L), dtype=torch.uint8, device=seq.device)
    with torch.cuda.device(seq.device):
        err = lib.bs_validate_decode(
            seq.data_ptr(), qual.data_ptr(), lengths.data_ptr(),
            codes.data_ptr(), phred.data_ptr(), n, L, int(col_offset),
            int(q_lower), int(q_upper), int(offset), int(bool(check_ascii)),
            int(bool(check_quality)),
            4 * _kernels.sm_count(seq.device.index),
            _kernels.stream_ptr(seq.device))
    _kernels.check(err, "bs_validate_decode")
    validate_decode.launches += 1
    return codes, phred


def validate_decode(seq, qual, lengths, schema, check_ascii: bool = True,
                    check_quality: bool = True, col_offset: int = 0):
    """Validate + decode one padded batch against a QualitySchema. CPU
    tensors run the plain torch version; CUDA tensors run the kernel
    (counted in `validate_decode.launches`) or raise."""
    args = (seq, qual, lengths, int(schema.LOWER), int(schema.UPPER),
            int(schema.OFFSET), check_ascii, check_quality, col_offset)
    if seq.is_cuda:
        return _validate_decode_cuda(*args)
    if seq.device.type != "cpu":
        raise ValueError("validate_decode: unsupported device %s"
                         % seq.device)
    return validate_decode_torch(*args)


validate_decode.launches = 0
