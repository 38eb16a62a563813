"""Device-side structural scanning of raw FASTQ bytes (counterpart of
blazeseq_tpu/ops/scan.py).

Raw bytes already on the device become record counts, boundary tables and
padded batches, with no host byte work:

* `structural_bitmaps`: '\\n' / '@' / '+' occupancy bitmaps packed 32
  positions per word, plus a newline count per 128-byte row. CPU tensors
  run the plain `structural_bitmaps_torch`; CUDA tensors run the
  hand-written kernel in csrc/scan.cu (counted in
  `structural_bitmaps.launches`) or raise. `count_records_device` is its
  caller.
* `newline_positions_device`, `record_offsets_device`,
  `gather_padded_device` and `parse_fastq_device`: torch ops on whatever
  device the chunk lies on.

Shapes are static: callers fix `max_records` per chunk and get the count
back. Compaction is an inclusive cumsum rank and a scatter into a
`[max_count + 1]` buffer whose last slot takes every non-hit and every hit
past `max_count`, so it needs no host sync.
"""

from __future__ import annotations

import torch

from .. import _kernels
from .common import AT, NEWLINE, PLUS, round_up

_LANE = 128
_WORDS_PER_ROW = _LANE // 32
# weight of bit b as an int32: the sum of distinct powers of two, with
# 2^31 as INT32_MIN, is the uint32 bit pattern in two's complement
_BIT_WEIGHTS = [1 << b for b in range(31)] + [-(1 << 31)]


def structural_bitmaps_torch(chunk: torch.Tensor):
    """Plain torch version of `structural_bitmaps` (same outputs)."""
    rows = _rows(chunk)
    x = chunk.view(rows, _WORDS_PER_ROW, 32)
    w = torch.tensor(_BIT_WEIGHTS, dtype=torch.int32, device=chunk.device)

    def pack(mask):
        return (mask.to(torch.int32) * w).sum(2, dtype=torch.int32)

    nl = x == NEWLINE
    counts = nl.view(rows, _LANE).sum(1, keepdim=True, dtype=torch.int32)
    return pack(nl), pack(x == AT), pack(x == PLUS), counts


def _rows(chunk) -> int:
    if chunk.dim() != 1 or chunk.dtype != torch.uint8:
        raise ValueError("structural_bitmaps: chunk must be u8[N], got %s %s"
                         % (chunk.dtype, tuple(chunk.shape)))
    if chunk.shape[0] % _LANE:
        raise ValueError("structural_bitmaps: chunk length %d is not a "
                         "multiple of 128" % chunk.shape[0])
    return chunk.shape[0] // _LANE


def _structural_bitmaps_cuda(chunk):
    rows = _rows(chunk)
    if not chunk.is_contiguous():
        raise ValueError("structural_bitmaps: chunk must be contiguous")
    lib = _kernels.load()
    out = [torch.empty((rows, _WORDS_PER_ROW), dtype=torch.int32,
                       device=chunk.device) for _ in range(3)]
    counts = torch.empty((rows, 1), dtype=torch.int32, device=chunk.device)
    with torch.cuda.device(chunk.device):
        err = lib.bs_structural_bitmaps(
            chunk.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
            out[2].data_ptr(), counts.data_ptr(), rows,
            16 * _kernels.sm_count(chunk.device.index),
            _kernels.stream_ptr(chunk.device))
    _kernels.check(err, "bs_structural_bitmaps")
    structural_bitmaps.launches += 1
    return out[0], out[1], out[2], counts


def structural_bitmaps(chunk: torch.Tensor):
    """chunk u8[N] (N % 128 == 0) -> (nl, at, plus) bitmaps [N/128, 4] and
    per-row newline counts i32[N/128, 1]. Bit b of word w marks byte
    32w + b of the 128-byte row. The bitmaps are int32 tensors holding the
    reference's uint32 bit patterns (torch's uint32 supports few ops):
    compare them through `.cpu().numpy().view(np.uint32)`.

    CPU tensors run the plain torch version; CUDA tensors run the kernel
    (counted in `structural_bitmaps.launches`) or raise."""
    if chunk.is_cuda:
        return _structural_bitmaps_cuda(chunk)
    if chunk.device.type != "cpu":
        raise ValueError("structural_bitmaps: unsupported device %s"
                         % chunk.device)
    return structural_bitmaps_torch(chunk)


structural_bitmaps.launches = 0


def _pad_lane(chunk: torch.Tensor) -> torch.Tensor:
    """Zero-pad to a multiple of 128 bytes (zeros match none of the three
    structural bytes)."""
    n = chunk.shape[0]
    target = round_up(n, _LANE)
    if target != n:
        chunk = torch.nn.functional.pad(chunk, (0, target - n))
    return chunk


def count_records_device(chunk: torch.Tensor) -> torch.Tensor:
    """Complete records (newlines // 4) of a raw chunk, as a 0-d int32
    tensor on the chunk's device."""
    _, _, _, counts = structural_bitmaps(_pad_lane(chunk))
    return counts.sum(dtype=torch.int32) // 4


def _compact_positions(mask: torch.Tensor, max_count: int):
    """Positions of set bits of `mask` (bool [n]) in order, as i32[max_count]
    padded with n, and the UNCAPPED hit count (i32[]): it counts hits past
    max_count too."""
    n = mask.shape[0]
    rank = torch.cumsum(mask, 0, dtype=torch.int32)  # inclusive
    total = rank[-1] if n else torch.zeros((), dtype=torch.int32,
                                           device=mask.device)
    slot = torch.where(mask, (rank - 1).clamp_(max=max_count), max_count)
    pos = torch.full((max_count + 1,), n, dtype=torch.int32,
                     device=mask.device)
    src = torch.arange(n, dtype=torch.int32, device=mask.device)
    pos.scatter_(0, slot.to(torch.int64), src)
    return pos[:max_count], total


def newline_positions_device(chunk: torch.Tensor, max_count: int):
    """Positions of '\\n' bytes, compacted to a static-size tensor.

    Returns (positions i32[max_count] padded with len(chunk), count i32[];
    the count is not capped at max_count)."""
    return _compact_positions(chunk == NEWLINE, max_count)


def record_offsets_device(chunk: torch.Tensor, max_records: int,
                          start: int = 0):
    """FASTQ boundary extraction for one chunk. Newlines before `start` are
    ignored and record 0's header begins at `start`.

    Returns:
      offsets i32[max_records, 5] (header/seq/sep/qual starts + record end,
        the reference's RecordOffsets layout; rows past the count hold -1)
      n_records i32[] complete records found: newlines // 4, NOT capped at
        max_records
      codes i32[max_records] structure codes per record (0 OK, 1 ID_NO_AT,
        2 SEP_NO_PLUS, 3 SEQ_QUAL_LEN_MISMATCH; 1 wins over 2 over 3; 0 past
        the count)
    """
    n = chunk.shape[0]
    start = int(start)
    mask = chunk == NEWLINE
    mask[:start] = False
    nl, count = _compact_positions(mask, max_records * 4)
    nl4 = nl.view(max_records, 4)

    n_rec = count // 4
    rec_valid = (torch.arange(max_records, dtype=torch.int32,
                              device=chunk.device) < n_rec)
    header = torch.cat([nl4.new_full((1,), start), nl4[:-1, 3] + 1])
    offsets = torch.stack(
        [header, nl4[:, 0] + 1, nl4[:, 1] + 1, nl4[:, 2] + 1, nl4[:, 3]],
        dim=1)
    offsets = torch.where(rec_valid[:, None], offsets, -1)

    # structure checks through gathers clamped into the chunk (padding rows
    # read real bytes and are masked after)
    h = header.clamp(0, n - 1)
    p = (nl4[:, 1] + 1).clamp(0, n - 1)
    seq_len = nl4[:, 1] - nl4[:, 0] - 1
    qual_len = nl4[:, 3] - (nl4[:, 2] + 1)
    codes = torch.zeros(max_records, dtype=torch.int32, device=chunk.device)
    codes = torch.where(seq_len != qual_len, 3, codes)
    codes = torch.where(chunk.index_select(0, p) != PLUS, 2, codes)
    codes = torch.where(chunk.index_select(0, h) != AT, 1, codes)
    codes = torch.where(rec_valid, codes, 0).to(torch.int32)
    return offsets, n_rec, codes


def gather_padded_device(chunk: torch.Tensor, offsets: torch.Tensor,
                         max_records: int, max_len: int):
    """Offsets -> padded seq/qual u8[max_records, max_len] + lengths
    i32[max_records]. Rows are cut at max_len; the lengths are the true
    ones, not clamped. Gathers clip into [0, n - 1]."""
    n = chunk.shape[0]
    if offsets.shape != (max_records, 5):
        raise ValueError("gather_padded_device: offsets must be [%d, 5], got "
                         "%s" % (max_records, tuple(offsets.shape)))
    valid = offsets[:, 0] >= 0
    seq_start = torch.where(valid, offsets[:, 1], 0)
    qual_start = torch.where(valid, offsets[:, 3], 0)
    lengths = torch.where(valid, offsets[:, 2] - offsets[:, 1] - 1,
                          0).to(torch.int32)
    col = torch.arange(max_len, dtype=torch.int32, device=chunk.device)
    in_row = col[None, :] < lengths[:, None]

    def rows(first):
        idx = (first[:, None] + col[None, :]).clamp_(0, n - 1)
        got = chunk.index_select(0, idx.view(-1)).view(max_records, max_len)
        return torch.where(in_row, got, 0).to(torch.uint8)

    return rows(seq_start), rows(qual_start), lengths


def parse_fastq_device(chunk: torch.Tensor, max_records: int, max_len: int):
    """Raw byte chunk -> padded batch on the chunk's device.

    Returns (seq u8[max_records, max_len], qual u8[max_records, max_len],
             lengths i32[max_records], n_records i32[], codes
             i32[max_records])."""
    offsets, n_rec, codes = record_offsets_device(chunk, max_records)
    seq, qual, lengths = gather_padded_device(chunk, offsets, max_records,
                                              max_len)
    return seq, qual, lengths, n_rec, codes
