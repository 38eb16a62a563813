"""Reference of the cli route's `trim` command: the bytes it writes and
the counts it prints, from the generated bytes.

Trimmomatic's SLIDINGWINDOW:w:q as the command states it: Phred = quality
byte - offset (0 below the offset); a read is cut at the start of its
first window of w bases, wholly inside the read, whose Phred sum is below
q * w; a read with no such window is kept whole; a read cut to nothing is
dropped. Each kept record is written as its id line, the kept bases, a
bare '+' line and the kept qualities, in input order.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from . import _fastq as fq

_BLOCK = 1 << 18  # records a block


def cuts(data, recs, window: int, mean_q: int, offset: int,
         raw_uint8: bool = False) -> torch.Tensor:
    """Each read's kept length. `raw_uint8` is the control: window sums of
    the raw quality bytes in wrapping 8-bit lanes against q * w plus the
    offset's w bytes, as a byte-wise kernel that never widens would."""
    out = []
    for lo, hi in fq.blocks(len(recs), _BLOCK):
        qual, mask = fq.rows(data, recs.qual_start[lo:hi],
                             recs.qual_len[lo:hi], 1 << 30)
        lens = recs.seq_len[lo:hi]
        n, w = qual.shape
        if w < window:
            out.append(lens.clone())
            continue
        if raw_uint8:
            q = torch.where(mask, qual.to(torch.int64), 0)
            s = q.unfold(1, window, 1).sum(2) & 0xFF
            low = s < (mean_q * window + offset * window) & 0xFF
        else:
            q = torch.where(mask & (qual.to(torch.int64) >= offset),
                            qual.to(torch.int64) - offset, 0)
            s = q.unfold(1, window, 1).sum(2)
            low = s < mean_q * window
        j = torch.arange(s.shape[1], device=data.device)[None, :]
        low &= j + window <= lens[:, None]
        big = torch.iinfo(torch.int64).max
        first = torch.where(low, j, big).amin(1)
        out.append(torch.minimum(first, lens))
    return torch.cat(out) if out else torch.empty(0, dtype=torch.int64)


def output_bytes(data, recs, keep: torch.Tensor) -> np.ndarray:
    """The command's output for kept lengths `keep`: id line, kept bases,
    '+', kept qualities, each line ending in a newline; empty reads
    dropped."""
    tail = torch.frombuffer(bytearray(b"\n+\n"), dtype=torch.uint8).to(
        data.device)
    src = torch.cat([data, tail])
    plus, nl = data.numel(), data.numel()  # "\n+\n" and its "\n"
    parts = []
    for lo, hi in fq.blocks(len(recs), _BLOCK):
        k = keep[lo:hi]
        sel = k > 0
        k = k[sel]
        starts = torch.stack([recs.id_start[lo:hi][sel],
                              recs.seq_start[lo:hi][sel],
                              torch.full_like(k, plus),
                              recs.qual_start[lo:hi][sel],
                              torch.full_like(k, nl)], 1).reshape(-1)
        lens = torch.stack([recs.id_len[lo:hi][sel] + 1, k,
                            torch.full_like(k, 3), k,
                            torch.ones_like(k)], 1).reshape(-1)
        total = int(lens.sum())
        seg_at = torch.cumsum(lens, 0) - lens
        base = torch.repeat_interleave(starts - seg_at, lens)
        idx = base + torch.arange(total, device=data.device)
        parts.append(src[idx].cpu().numpy())
    return np.concatenate(parts) if parts else np.empty(0, np.uint8)


def printed_counts(text: str):
    """(reads, kept, bases in, bases out) from the command's line."""
    m = re.search(r"reads (\d+) -> kept (\d+)\tbases (\d+) -> (\d+)", text)
    return tuple(int(v) for v in m.groups()) if m else None


def expected(corpus, config, params, device, raw_uint8: bool = False):
    data = fq.to_device(corpus.file.array(), device)
    corpus.file.release()
    recs = fq.records(data)
    keep = cuts(data, recs, int(params["window"]), int(params["mean_q"]),
                int(config["quality_offset"]), raw_uint8=raw_uint8)
    counts = (len(recs), int((keep > 0).sum()), int(recs.seq_len.sum()),
              int(keep.sum()))
    return dict(bytes=output_bytes(data, recs, keep), counts=counts)


def records_differing(got: np.ndarray, want: np.ndarray) -> int:
    """Records of the expected output that the written bytes do not hold at
    the same place, plus the difference in record counts (0 when the bytes
    are equal)."""
    if got.shape == want.shape and np.array_equal(got, want):
        return 0
    a, b = _lines(got), _lines(want)
    n = min(len(a), len(b))
    same = sum(1 for i in range(n) if a[i] == b[i])
    return max(len(a), len(b)) - same


def _lines(buf: np.ndarray) -> list:
    """The records of an output buffer as tuples of their four lines."""
    lines = buf.tobytes().split(b"\n")
    if lines and lines[-1] == b"":
        lines.pop()
    return [tuple(lines[i:i + 4]) for i in range(0, len(lines), 4)]


def judge(answers, want: dict) -> dict:
    """answers: each request's printed line, and the bytes of the requests
    whose output was kept; none kept counts every expected record as
    missing."""
    printed = [printed_counts(a["stdout"]) for a in answers]
    wrote = [records_differing(a["output"], want["bytes"])
             for a in answers if a.get("output") is not None]
    return dict(records_differing=(max(wrote) if wrote
                                   else want["counts"][1], 0),
                requests_wrong=(sum(1 for p in printed
                                    if p != want["counts"]), 0))
