"""Device-side structural scanning of raw FASTQ bytes (counterpart of
blazeseq_tpu/ops/scan.py).

Raw bytes already on the device become record counts, boundary tables and
padded batches, with no host byte work:

* `structural_bitmaps`: '\\n' / '@' / '+' occupancy bitmaps packed 32
  positions per word, plus a newline count per 128-byte row. CPU tensors
  run the plain `structural_bitmaps_torch`; CUDA tensors run the
  hand-written kernel in csrc/scan.cu (counted in
  `structural_bitmaps.launches`) or raise. `count_records_device` is its
  caller: on the card it runs the scan kernel on the chunk's 128-byte
  rows and csrc/parse.cu's record-count kernel on their counts and the
  n % 128 bytes past them (`count_records_device.launches`), with no copy
  of the chunk.
* `newline_positions_device`, `record_offsets_device`,
  `gather_padded_device`: CPU tensors run the plain torch versions
  `newline_positions_torch`, `record_offsets_torch` and
  `gather_padded_torch`; CUDA tensors run the kernels of csrc/parse.cu or
  raise: the newline compaction (`newline_positions_device.launches`,
  counted also where `record_offsets_device` runs it), the record pass
  (`record_offsets_device.launches`) and the padded gather
  (`gather_padded_device.launches`). `parse_fastq_device` is the last two
  in turn. The compaction reads the chunk once (a decoupled look-back over
  the tiles' counts). The kernels keep no O(N) intermediate: their scratch
  is 8 bytes per 16 KiB tile of the chunk and a few counters.

Shapes are static: callers fix `max_records` per chunk and get the count
back. The plain compaction is an inclusive cumsum rank and a scatter into
a `[max_count + 1]` buffer whose last slot takes every non-hit and every
hit past `max_count`, so it needs no host sync; so do the kernels.
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
    dev = chunk.device
    out = [torch.empty((rows, _WORDS_PER_ROW), dtype=torch.int32,
                       device=dev) for _ in range(3)]
    counts = torch.empty((rows, 1), dtype=torch.int32, device=dev)
    # any chunk address: the kernel has a branch for views off 16-byte
    # alignment. A grid of up to 64 blocks per SM takes a 256 MiB chunk in
    # one step per thread (the fastest cap of 4-64 on the H100)
    with _kernels.on_device(dev):
        err = lib.bs_structural_bitmaps(
            chunk.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
            out[2].data_ptr(), counts.data_ptr(), rows,
            64 * _kernels.sm_count(dev.index), _kernels.stream_ptr(dev))
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


def count_records_torch(chunk: torch.Tensor) -> torch.Tensor:
    """Plain torch version of `count_records_device`: the padded chunk's
    bitmaps, their row counts summed."""
    _, _, _, counts = structural_bitmaps_torch(_pad_lane(chunk))
    return counts.sum(dtype=torch.int32) // 4


def count_records_device(chunk: torch.Tensor) -> torch.Tensor:
    """Complete records (newlines // 4) of a raw chunk, as a 0-d int32
    tensor on the chunk's device.

    CPU tensors run `count_records_torch`. CUDA tensors run the scan kernel
    on the chunk's whole 128-byte rows, then the record-count kernel on
    their counts and the last n % 128 bytes (counted in
    `count_records_device.launches`), or raise."""
    if not chunk.is_cuda:
        if chunk.device.type != "cpu":
            raise ValueError("count_records_device: unsupported device %s"
                             % chunk.device)
        return count_records_torch(chunk)
    n = _chunk_len("count_records_device", chunk)
    lib = _kernels.load()
    dev = chunk.device
    body = n // _LANE * _LANE
    if body:
        _, _, _, counts = structural_bitmaps(chunk[:body])
    else:
        counts = torch.zeros((0, 1), dtype=torch.int32, device=dev)
    # a sum and a counter of finished blocks, then the count
    work = torch.empty(3, dtype=torch.int32, device=dev)
    with _kernels.on_device(dev):
        err = lib.bs_count_records(
            counts.data_ptr(), body // _LANE, chunk.data_ptr() + body,
            n - body, work.data_ptr(), work.data_ptr() + 8,
            8 * _kernels.sm_count(dev.index), _kernels.stream_ptr(dev))
    _kernels.check(err, "bs_count_records")
    count_records_device.launches += 1
    return work[2]


count_records_device.launches = 0


# bytes a block of csrc/parse.cu takes (its kTile): the kernels' scratch is
# a 64-bit status word a tile and a few counters
PARSE_TILE_BYTES = 16384
# offsets are int32
_MAX_BYTES = (1 << 31) - 1


def parse_tiles(address: int, n: int) -> int:
    """Tiles of csrc/parse.cu over a chunk at `address` with n bytes: tiles
    start at the address rounded down to 16 bytes."""
    return -(-(address % 16 + n) // PARSE_TILE_BYTES) if n > 0 else 0


def _chunk_len(who: str, chunk: torch.Tensor) -> int:
    """n of a chunk the CUDA path takes: contiguous u8[n], n < 2^31."""
    if chunk.dim() != 1 or chunk.dtype != torch.uint8:
        raise ValueError("%s: chunk must be u8[n], got %s %s"
                         % (who, chunk.dtype, tuple(chunk.shape)))
    if not chunk.is_contiguous():
        raise ValueError("%s: chunk must be contiguous" % who)
    n = chunk.shape[0]
    if n > _MAX_BYTES:
        raise ValueError("%s: chunk of %d bytes; offsets are int32" % (who, n))
    return n


def _start(who: str, start) -> int:
    start = int(start)
    if not 0 <= start <= _MAX_BYTES:
        raise ValueError("%s: start %d outside [0, 2^31)" % (who, start))
    return start


def _scratch(chunk: torch.Tensor, per_tile: int, extra: int):
    """(tiles, int32 scratch of per_tile * tiles + extra) for a parse.cu
    call."""
    tiles = parse_tiles(chunk.data_ptr(), chunk.shape[0])
    return tiles, torch.empty(per_tile * tiles + extra, dtype=torch.int32,
                              device=chunk.device)


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


def newline_positions_torch(chunk: torch.Tensor, max_count: int):
    """Plain torch version of `newline_positions_device`."""
    return _compact_positions(chunk == NEWLINE, max_count)


def _newline_positions_cuda(chunk, max_count):
    n = _chunk_len("newline_positions_device", chunk)
    lib = _kernels.load()
    dev = chunk.device
    # the positions, then the uncapped count
    out = torch.empty(max_count + 1, dtype=torch.int32, device=dev)
    # a 64-bit status word a tile, then the tile counter and the count
    tiles, scratch = _scratch(chunk, 2, 2)
    with _kernels.on_device(dev):
        err = lib.bs_newline_positions(
            chunk.data_ptr(), n, 0, max_count, out.data_ptr(),
            scratch.data_ptr(), tiles, 64 * _kernels.sm_count(dev.index),
            _kernels.stream_ptr(dev))
    _kernels.check(err, "bs_newline_positions")
    newline_positions_device.launches += 1
    return out[:max_count], out[max_count]


def newline_positions_device(chunk: torch.Tensor, max_count: int):
    """Positions of '\\n' bytes, compacted to a static-size tensor.

    Returns (positions i32[max_count] padded with len(chunk), count i32[];
    the count is not capped at max_count). CPU tensors run
    `newline_positions_torch`; CUDA tensors run the compaction kernel
    (counted in `newline_positions_device.launches`) or raise."""
    max_count = int(max_count)
    if max_count < 0:
        raise ValueError("newline_positions_device: max_count %d < 0"
                         % max_count)
    if chunk.is_cuda:
        return _newline_positions_cuda(chunk, max_count)
    if chunk.device.type != "cpu":
        raise ValueError("newline_positions_device: unsupported device %s"
                         % chunk.device)
    return newline_positions_torch(chunk, max_count)


newline_positions_device.launches = 0


def record_offsets_torch(chunk: torch.Tensor, max_records: int,
                         start: int = 0):
    """Plain torch version of `record_offsets_device`."""
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


def _record_offsets_cuda(chunk, max_records, start):
    n = _chunk_len("record_offsets_device", chunk)
    lib = _kernels.load()
    dev = chunk.device
    offsets = torch.empty((max_records, 5), dtype=torch.int32, device=dev)
    # the codes, then the uncapped record count
    codes = torch.empty(max_records + 1, dtype=torch.int32, device=dev)
    tiles, scratch = _scratch(chunk, 2, 2)
    with _kernels.on_device(dev):
        err = lib.bs_record_offsets(
            chunk.data_ptr(), n, start, max_records, offsets.data_ptr(),
            codes.data_ptr(), scratch.data_ptr(), tiles,
            64 * _kernels.sm_count(dev.index), _kernels.stream_ptr(dev))
    _kernels.check(err, "bs_record_offsets")
    # the compaction kernel, then the record pass
    if n and max_records:
        newline_positions_device.launches += 1
    record_offsets_device.launches += 1
    return offsets, codes[max_records], codes[:max_records]


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

    CPU tensors run `record_offsets_torch`; CUDA tensors run the compaction
    kernel into the rows, then the record pass (counted in
    `record_offsets_device.launches`), or raise.
    """
    max_records = int(max_records)
    if max_records < 0:
        raise ValueError("record_offsets_device: max_records %d < 0"
                         % max_records)
    start = _start("record_offsets_device", start)
    if chunk.is_cuda:
        return _record_offsets_cuda(chunk, max_records, start)
    if chunk.device.type != "cpu":
        raise ValueError("record_offsets_device: unsupported device %s"
                         % chunk.device)
    return record_offsets_torch(chunk, max_records, start)


record_offsets_device.launches = 0


def _check_offsets(offsets, max_records):
    if offsets.shape != (max_records, 5):
        raise ValueError("gather_padded_device: offsets must be [%d, 5], got "
                         "%s" % (max_records, tuple(offsets.shape)))


def gather_padded_torch(chunk: torch.Tensor, offsets: torch.Tensor,
                        max_records: int, max_len: int):
    """Plain torch version of `gather_padded_device`."""
    n = chunk.shape[0]
    _check_offsets(offsets, max_records)
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


def _gather_padded_cuda(chunk, offsets, max_records, max_len):
    n = _chunk_len("gather_padded_device", chunk)
    _check_offsets(offsets, max_records)
    if (offsets.dtype != torch.int32 or not offsets.is_contiguous()
            or offsets.device != chunk.device):
        raise ValueError("gather_padded_device: offsets must be a contiguous "
                         "int32 tensor on the chunk's device")
    if max_len >= 1 << 24:
        raise ValueError("gather_padded_device: max_len %d >= 2^24"
                         % max_len)
    lib = _kernels.load()
    dev = chunk.device
    seq = torch.empty((max_records, max_len), dtype=torch.uint8, device=dev)
    qual = torch.empty((max_records, max_len), dtype=torch.uint8, device=dev)
    lengths = torch.empty(max_records, dtype=torch.int32, device=dev)
    with _kernels.on_device(dev):
        err = lib.bs_gather_padded(
            chunk.data_ptr(), n, offsets.data_ptr(), max_records, max_len,
            seq.data_ptr(), qual.data_ptr(), lengths.data_ptr(),
            _kernels.stream_ptr(dev))
    _kernels.check(err, "bs_gather_padded")
    gather_padded_device.launches += 1
    return seq, qual, lengths


def gather_padded_device(chunk: torch.Tensor, offsets: torch.Tensor,
                         max_records: int, max_len: int):
    """Offsets -> padded seq/qual u8[max_records, max_len] + lengths
    i32[max_records]. Rows are cut at max_len; the lengths are the true
    ones, not clamped. Gathers clip into [0, n - 1]: a quality line
    shorter than its sequence reads on into the next bytes. CPU tensors run
    `gather_padded_torch`; CUDA tensors run the gather kernel (counted in
    `gather_padded_device.launches`) or raise."""
    max_records, max_len = int(max_records), int(max_len)
    if max_records < 0 or max_len < 0:
        raise ValueError("gather_padded_device: max_records %d, max_len %d"
                         % (max_records, max_len))
    if chunk.is_cuda:
        return _gather_padded_cuda(chunk, offsets, max_records, max_len)
    if chunk.device.type != "cpu":
        raise ValueError("gather_padded_device: unsupported device %s"
                         % chunk.device)
    return gather_padded_torch(chunk, offsets, max_records, max_len)


gather_padded_device.launches = 0


def parse_fastq_device(chunk: torch.Tensor, max_records: int, max_len: int):
    """Raw byte chunk -> padded batch on the chunk's device:
    `record_offsets_device`, then `gather_padded_device` (the plain
    versions on CPU tensors, the kernels on CUDA tensors).

    Returns (seq u8[max_records, max_len], qual u8[max_records, max_len],
             lengths i32[max_records], n_records i32[], codes
             i32[max_records])."""
    offsets, n_rec, codes = record_offsets_device(chunk, max_records)
    seq, qual, lengths = gather_padded_device(chunk, offsets, max_records,
                                              max_len)
    return seq, qual, lengths, n_rec, codes
