"""Per-tile sequence quality, FastQC's "per tile sequence quality" panel
(counterpart of blazeseq_tpu/ops/tiles.py).

Illumina read ids carry the flowcell tile as the 5th colon-separated field
of the first whitespace token (`instr:run:flowcell:lane:tile:x:y`). Tile
numbers are parsed on the host from the id SoA, and the host maps each row
to its tile's row (`_tile_rows`), in file order: nothing is sorted. The
[tile, position] Phred sums and base counts are integer sums, exact on any
device whatever its float settings: CUDA tensors take the row map up in one
copy and one launch of the hand-written kernel in csrc/tiles.cu, which sums
in shared memory and writes every cell of the float32 sums itself (no fill;
counted in `per_tile_qual_sums.launches`), and the sums come back in one
copy; or the call raises. CPU tensors take the plain torch version
`per_tile_qual_sums_torch` (two int64 `index_add_`s). They are returned in
float32, as the reference returns them (exact below 2^24 per batch).
PerTileAccumulator adds batches in int64 on the host; `mean()` /
`deviation()` give the heatmap.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from .. import _kernels
from .common import _kept, check_cuda_batch
from .stats import MAX_PHRED


def parse_illumina_tiles(ids: np.ndarray, id_ends: np.ndarray) -> np.ndarray:
    """Tile numbers from a concatenated-id SoA (FastqBatch layout).

    Returns int32[n]; -1 where the id is not Illumina-coordinate-shaped."""
    n = len(id_ends)
    out = np.full(n, -1, dtype=np.int32)
    flat = ids.tobytes()
    start = 0
    for i in range(n):
        end = int(id_ends[i])
        tok = flat[start:end]
        start = end
        sp = tok.find(b" ")
        if sp >= 0:
            tok = tok[:sp]
        parts = tok.split(b":")
        if len(parts) >= 7:
            t = parts[4]
            if t.isdigit():
                out[i] = int(t)
    return out


def _tile_rows(tiles, n, unique_tiles, n_records):
    """(unique_tiles, dst int32[n], rows): the row of each batch row's tile,
    `rows` (= max(T, 1)) for unknown tiles and rows past n_records."""
    if n_records is None:
        n_records = n
    valid = np.arange(n) < n_records
    if unique_tiles is None:
        unique_tiles = np.unique(tiles[valid & (tiles >= 0)])
    n_t = len(unique_tiles)
    t_idx = np.clip(np.searchsorted(unique_tiles, tiles), 0, max(n_t - 1, 0))
    hit = valid & (tiles >= 0)
    if n_t:
        hit &= unique_tiles[t_idx] == tiles
    rows = max(n_t, 1)
    return unique_tiles, np.where(hit, t_idx, rows).astype(np.int32), rows


def per_tile_qual_sums_torch(tiles: np.ndarray, qual, lengths, offset: int,
                             unique_tiles: Optional[np.ndarray] = None,
                             n_records: Optional[int] = None
                             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Plain torch version of `per_tile_qual_sums`."""
    tiles = np.asarray(tiles)
    qual = torch.as_tensor(qual)
    lengths = torch.as_tensor(lengths)
    n, L = qual.shape
    unique_tiles, dst, rows = _tile_rows(tiles, n, unique_tiles, n_records)
    # rows of unknown tiles go to an extra row that is dropped
    dst = torch.from_numpy(dst.astype(np.int64)).to(qual.device)

    mask = (torch.arange(L, device=qual.device)[None, :]
            < lengths.to(torch.int64)[:, None])
    q = qual.to(torch.int64)
    off = int(offset)
    phred = torch.where(mask & (q >= off), q - off, 0).clamp_(
        max=MAX_PHRED - 1)
    sums = torch.zeros((rows + 1, L), dtype=torch.int64, device=qual.device)
    counts = torch.zeros_like(sums)
    sums.index_add_(0, dst, phred)
    counts.index_add_(0, dst, mask.to(torch.int64))
    sums, counts = (a[:rows].to(torch.float32).cpu().numpy()
                    for a in (sums, counts))
    return np.asarray(unique_tiles).astype(np.int64), sums, counts


def _tile_sums_launch(qual, lengths, dst, out, offset) -> None:
    """One launch of csrc/tiles.cu, counted in
    `per_tile_qual_sums.launches`: the rows of qual u8[n, L] (lengths i32
    [n]) summed by their tile row in dst (int32 [n] on the card, from
    _tile_rows; T = out.shape[1] or more for none) into every cell of out,
    float32 [2, T, L]."""
    n, L = qual.shape
    if not (n and L):
        return
    lib = _kernels.load()
    dev = qual.device
    T = out.shape[1]
    stream = _kernels.stream_ptr(dev)
    # a ticket a tile range (at most T) and 128-column span
    sums = _kept("sums", dev, stream, T * L, torch.int64)
    tickets = _kept("tickets", dev, stream, T * -(-L // 128), torch.int32)
    with _kernels.on_device(dev):
        err = lib.bs_tile_sums(qual.data_ptr(), lengths.data_ptr(),
                               dst.data_ptr(), out.data_ptr(),
                               sums.data_ptr(), tickets.data_ptr(), n, L, T,
                               offset, MAX_PHRED, _kernels.sm_count(dev.index),
                               stream)
    _kernels.check(err, "bs_tile_sums")
    per_tile_qual_sums.launches += 1


# set to a list, the CUDA call appends (step, time.perf_counter()) at the
# start and at the end of each of its steps, for a caller that times them
step_marks = None


def _mark(step):
    if step_marks is not None:
        step_marks.append((step, time.perf_counter()))


def _per_tile_qual_sums_cuda(tiles, qual, lengths, offset, unique_tiles,
                             n_records):
    """The row map made on the host and sent up in one copy, one launch
    into float32 [2, T, L], the sums back in one copy. A batch with no row
    of a known tile launches nothing."""
    _mark("start")
    lengths = torch.as_tensor(lengths).to(torch.int32)
    check_cuda_batch("per_tile_qual_sums", [("qual", qual)],
                     [("lengths", lengths)])
    n, L = qual.shape
    offset = int(offset)
    if not -(1 << 31) <= offset < (1 << 31):
        raise ValueError("per_tile_qual_sums: offset %d is not an int32"
                         % offset)
    _mark("checks")
    unique_tiles, dst, rows = _tile_rows(np.asarray(tiles), n, unique_tiles,
                                         n_records)
    unique_tiles = np.asarray(unique_tiles).astype(np.int64)
    if not (L and (dst < rows).any()):
        zeros = np.zeros((rows, L), np.float32)
        return unique_tiles, zeros, zeros.copy()
    _mark("tile_rows")
    dst = torch.from_numpy(dst).to(qual.device)
    _mark("upload")
    out = torch.empty((2, rows, L), dtype=torch.float32, device=qual.device)
    _mark("alloc")
    _tile_sums_launch(qual, lengths, dst, out, offset)
    _mark("launch")
    host = out.cpu().numpy()
    _mark("download")
    return unique_tiles, host[0], host[1]


def per_tile_qual_sums(tiles: np.ndarray, qual, lengths, offset: int,
                       unique_tiles: Optional[np.ndarray] = None,
                       n_records: Optional[int] = None
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One batch's per-tile per-position Phred sums and base counts.

    tiles: int32[n] (host); qual u8[n, L] and lengths i32[n] as tensors
    (the sums run on their device) or arrays (on the CPU).
    Returns (unique_tiles i64[T], sums f32[T, L], counts f32[T, L]) with
    T >= 1 rows (one zero row when no tile is known), as the reference
    returns them. CPU tensors run `per_tile_qual_sums_torch`; CUDA tensors
    run the kernel (counted in `per_tile_qual_sums.launches`) or raise."""
    qual = torch.as_tensor(qual)
    if qual.is_cuda:
        return _per_tile_qual_sums_cuda(tiles, qual, lengths, offset,
                                        unique_tiles, n_records)
    if qual.device.type != "cpu":
        raise ValueError("per_tile_qual_sums: unsupported device %s"
                         % qual.device)
    return per_tile_qual_sums_torch(tiles, qual, lengths, offset,
                                    unique_tiles, n_records)


per_tile_qual_sums.launches = 0


class PerTileAccumulator:
    """Cross-batch per-tile accumulation (int64 host sums, like
    QCAccumulator)."""

    def __init__(self):
        self._sums = {}    # tile -> int64[L]
        self._counts = {}  # tile -> int64[L]

    @staticmethod
    def _add_ragged(store, t, v):
        """Accumulate v into store[t], zero-extending either side: batch pad
        widths may differ from batch to batch."""
        old = store.get(t)
        if old is None:
            store[t] = v
        elif len(old) == len(v):
            old += v
        else:
            L = max(len(old), len(v))
            out = np.zeros(L, np.int64)
            out[: len(old)] = old
            out[: len(v)] += v
            store[t] = out

    def add_batch(self, tiles, qual, lengths, offset: int,
                  n_records: Optional[int] = None) -> None:
        uniq, sums, counts = per_tile_qual_sums(tiles, qual, lengths, offset,
                                                n_records=n_records)
        for k, t in enumerate(uniq.tolist()):
            self._add_ragged(self._sums, t,
                             np.rint(sums[k]).astype(np.int64))
            self._add_ragged(self._counts, t,
                             np.rint(counts[k]).astype(np.int64))

    @property
    def tiles(self):
        return sorted(self._sums)

    def _stacked(self, store, ts):
        """[T, Lmax] int64 matrix, rows zero-extended to the widest tile."""
        L = max(len(store[t]) for t in ts)
        out = np.zeros((len(ts), L), np.int64)
        for k, t in enumerate(ts):
            v = store[t]
            out[k, : len(v)] = v
        return out

    def mean(self) -> Tuple[np.ndarray, np.ndarray]:
        """(tiles i64[T], mean_phred f64[T, L]; NaN where a tile has no
        bases at a position)."""
        ts = self.tiles
        if not ts:
            return np.empty(0, np.int64), np.empty((0, 0))
        sums = self._stacked(self._sums, ts).astype(np.float64)
        counts = self._stacked(self._counts, ts).astype(np.float64)
        with np.errstate(invalid="ignore", divide="ignore"):
            return np.asarray(ts, np.int64), sums / counts

    def deviation(self) -> Tuple[np.ndarray, np.ndarray]:
        """FastQC heatmap values: per-tile mean minus the all-tile
        per-position mean."""
        ts, mean = self.mean()
        if not len(ts):
            return ts, mean
        tot_s = self._stacked(self._sums, ts).sum(axis=0).astype(np.float64)
        tot_c = self._stacked(self._counts, ts).sum(axis=0).astype(np.float64)
        with np.errstate(invalid="ignore", divide="ignore"):
            overall = tot_s / tot_c
        return ts, mean - overall[None, :]
