"""Per-tile sequence quality, FastQC's "per tile sequence quality" panel
(counterpart of blazeseq_tpu/ops/tiles.py).

Illumina read ids carry the flowcell tile as the 5th colon-separated field
of the first whitespace token (`instr:run:flowcell:lane:tile:x:y`). Tile
numbers are parsed on the host from the id SoA, and the host maps each row
to its tile's row (`_tile_rows`). The [tile, position] Phred sums and base
counts are integer sums, exact on any device whatever its float settings:
CUDA tensors take one launch of the hand-written kernel in csrc/tiles.cu
after one zero fill (counted in `per_tile_qual_sums.launches`) or the call
raises; CPU tensors take the plain torch version
`per_tile_qual_sums_torch` (two int64 `index_add_`s). They are returned in
float32, as the reference returns them (exact below 2^24 per batch).
PerTileAccumulator adds batches in int64 on the host; `mean()` /
`deviation()` give the heatmap.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import _kernels
from .common import check_cuda_batch
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


def _tile_order(dst, rows):
    """The rows of known tiles (dst < rows) grouped by tile, for the
    kernel: int32 [2, k], their indices, then their tile rows. Keys of 16
    bits take numpy's stable radix sort, int32 keys its merge sort."""
    key = dst.astype(np.uint16) if rows < (1 << 16) else dst
    order = np.argsort(key, kind="stable")[:int((dst < rows).sum())]
    return np.stack([order, dst[order]]).astype(np.int32)


def _tile_sums_launch(qual, lengths, order, out, offset) -> None:
    """One launch of csrc/tiles.cu, counted in
    `per_tile_qual_sums.launches`: the rows of qual u8[n, L] (lengths i32
    [n]) that `order` (int32 [2, k] on the card, from _tile_order) lists
    added into out, zeroed int64 [2, T, L]."""
    k = order.shape[1]
    L = qual.shape[1]
    if not (k and L):
        return
    lib = _kernels.load()
    dev = qual.device
    with _kernels.on_device(dev):
        err = lib.bs_tile_sums(qual.data_ptr(), lengths.data_ptr(),
                               order.data_ptr(), out.data_ptr(), k, L,
                               out.shape[1], offset, MAX_PHRED,
                               _kernels.sm_count(dev.index),
                               _kernels.stream_ptr(dev))
    _kernels.check(err, "bs_tile_sums")
    per_tile_qual_sums.launches += 1


def _per_tile_qual_sums_cuda(tiles, qual, lengths, offset, unique_tiles,
                             n_records):
    """The rows of known tiles grouped by tile on the host and sent up in
    one copy, one zero fill and one launch into int64 [2, T, L], the sums
    back in one copy, made float32 on the host."""
    lengths = torch.as_tensor(lengths).to(torch.int32)
    check_cuda_batch("per_tile_qual_sums", [("qual", qual)],
                     [("lengths", lengths)])
    n, L = qual.shape
    offset = int(offset)
    if not -(1 << 31) <= offset < (1 << 31):
        raise ValueError("per_tile_qual_sums: offset %d is not an int32"
                         % offset)
    unique_tiles, dst, rows = _tile_rows(np.asarray(tiles), n, unique_tiles,
                                         n_records)
    out = torch.zeros((2, rows, L), dtype=torch.int64, device=qual.device)
    order = torch.from_numpy(_tile_order(dst, rows)).to(qual.device)
    _tile_sums_launch(qual, lengths, order, out, offset)
    host = out.cpu().numpy().astype(np.float32)
    return np.asarray(unique_tiles).astype(np.int64), host[0], host[1]


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
