"""Input sharding on FASTQ record boundaries (the port's copy of
blazeseq_tpu/parallel/sharding.py, host-only).

`shard_file` splits a file into contiguous byte ranges whose cuts never fall
inside a record; `find_record_boundary_bytes` does the same for one offset
of an in-memory buffer, and cuts the chunks of the ragged tier of
`QCModel.run_file_device`. Both probe a small window at the candidate offset
and resynchronize to the next record start with the 4-line frame invariant:
an '@' line whose +2 line starts with '+' and whose sequence and quality
lines have one length (quality lines may start with '@', so a lone '@' is
not enough)."""

from __future__ import annotations

import os
from typing import List, Tuple

from ..constants import MB


def _resync_offset(window: bytes, base: int) -> int:
    """Absolute offset of the first record start at/after `base` within
    window (window is anchored at absolute offset `base`). Returns -1 when no
    boundary is provable inside the window."""
    # line starts within the window
    starts = [0] + [i + 1 for i, b in enumerate(window) if b == 10]
    lines = []
    for k, s in enumerate(starts):
        e = window.find(b"\n", s)
        if e < 0:
            e = len(window)
        lines.append((s, e))
    for k in range(len(lines) - 3):
        s, e = lines[k]
        if e <= s or window[s] != 64:  # '@'
            continue
        s2, e2 = lines[k + 2]
        if e2 <= s2 or window[s2] != 43:  # '+'
            continue
        seq_len = lines[k + 1][1] - lines[k + 1][0]
        qual_len = lines[k + 3][1] - lines[k + 3][0]
        if seq_len == qual_len:
            return base + s
    return -1


def _boundary_in_window(window: bytes, offset: int, prev_byte: int,
                        size: int) -> int:
    """Shared anchor+resync: first record start at/after `offset` given
    the probe `window` anchored there and the byte before it (`size` when
    none is provable)."""
    if prev_byte != 10:  # anchor to the next line start
        nl = window.find(b"\n")
        if nl < 0:
            return size
        window = window[nl + 1:]
        offset += nl + 1
    pos = _resync_offset(window, offset)
    return pos if pos >= 0 else size


def find_record_boundary_bytes(data, offset: int, probe: int = 1 * MB) -> int:
    """First FASTQ record start at/after `offset` in an in-memory buffer
    (len(data) when none found)."""
    size = len(data)
    if offset <= 0:
        return 0
    if offset >= size:
        return size
    window = bytes(data[offset: offset + min(probe, size - offset)])
    return _boundary_in_window(window, offset, data[offset - 1], size)


def find_record_boundary(path, offset: int, probe: int = 1 * MB) -> int:
    """First FASTQ record start at/after `offset` in the file (file size when
    none found)."""
    size = os.path.getsize(path)
    if offset <= 0:
        return 0
    if offset >= size:
        return size
    with open(path, "rb") as f:
        f.seek(offset - 1)
        prev = f.read(1)
        window = f.read(min(probe, size - offset))
    return _boundary_in_window(window, offset, prev[0], size)


def _fqi_cuts(path, size: int, n_shards: int):
    """Exact cut offsets from a fresh ``<path>.fqi`` record index, or None.

    A sidecar built by ``build_fqi`` (fastq/index.py) replaces the probe
    heuristic with PROVEN record starts: no resync window, no dependence on
    the frame invariant holding inside the probe. Ignored when absent,
    unreadable, or stale (recorded size != file size)."""
    fqi = str(path) + ".fqi"
    if not os.path.exists(fqi):
        return None
    try:
        from ..fastq.index import read_fqi

        ix = read_fqi(fqi)
    except Exception:
        return None
    if ix.n_bytes != size or len(ix.offsets) == 0:
        return None
    import numpy as np

    offs = ix.offsets
    cuts = [0]
    for i in range(1, n_shards):
        target = size * i // n_shards
        k = int(np.searchsorted(offs, target))
        cuts.append(max(int(offs[k]) if k < len(offs) else size, cuts[-1]))
    cuts.append(size)
    return cuts


def shard_file(path, n_shards: int) -> List[Tuple[int, int]]:
    """Split a FASTQ file into n contiguous byte ranges on record boundaries.
    Ranges cover the file exactly; a shard may be empty when records are
    larger than size/n. When a fresh ``<path>.fqi`` sidecar exists the cuts
    come from its proven record offsets (exact, no probe window); otherwise
    the resync heuristic above finds the boundaries."""
    size = os.path.getsize(path)
    cuts = _fqi_cuts(path, size, n_shards)
    if cuts is None:
        cuts = [0]
        for i in range(1, n_shards):
            target = size * i // n_shards
            cut = find_record_boundary(path, target)
            cuts.append(max(cut, cuts[-1]))
        cuts.append(size)
    return [(cuts[i], cuts[i + 1]) for i in range(n_shards)]


class RangeReader:
    """Reader over a byte range of a file (one host's shard)."""

    def __init__(self, path, start: int, end: int):
        self._f = open(path, "rb", buffering=0)
        self._f.seek(start)
        self._remaining = end - start

    def readinto(self, buf: memoryview) -> int:
        if self._remaining <= 0:
            return 0
        n = self._f.readinto(buf[: min(len(buf), self._remaining)])
        n = n or 0
        self._remaining -= n
        return n

    def close(self) -> None:
        self._f.close()


def open_shard(path, n_shards: int, shard_id: int) -> RangeReader:
    """Reader for shard `shard_id` of `path` (shard ids count from 0)."""
    ranges = shard_file(path, n_shards)
    start, end = ranges[shard_id]
    return RangeReader(path, start, end)
