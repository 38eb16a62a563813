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
from .common import check_cuda_batch, length_mask

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


def lane_group(L: int, *ptrs: int) -> int:
    """Lanes per row of the kernel's vector path (16 columns a lane, up to
    32 lanes), or 0 for its byte path: rows of L % 16 != 0 bytes, empty
    rows, or a pointer that is not 16-byte aligned."""
    if L <= 0 or L % 16 or any(p % 16 for p in ptrs):
        return 0
    return min(32, 1 << (L // 16 - 1).bit_length())


def _validate_decode_cuda(seq, qual, lengths, q_lower, q_upper, offset,
                          check_ascii, check_quality, col_offset):
    check_cuda_batch("validate_decode", [("seq", seq), ("qual", qual)],
                     [("lengths", lengths)])
    lib = _kernels.load()
    n, L = seq.shape
    dev = seq.device
    codes = torch.empty(n, dtype=torch.int32, device=dev)
    phred = torch.empty((n, L), dtype=torch.uint8, device=dev)
    ptrs = (seq.data_ptr(), qual.data_ptr(), phred.data_ptr())
    args = (ptrs[0], ptrs[1], lengths.data_ptr(), codes.data_ptr(), ptrs[2],
            n, L, int(col_offset), int(q_lower), int(q_upper), int(offset),
            int(bool(check_ascii)), int(bool(check_quality)),
            lane_group(L, *ptrs), 8 * _kernels.sm_count(dev.index),
            _kernels.stream_ptr(dev))
    with _kernels.on_device(dev):
        err = lib.bs_validate_decode(*args)
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
