"""What the generators share: a counter-based hash in wrapping int64 torch
arithmetic (the same bits on the card and on the CPU), digits of numbers
as bytes, rows of pieces of varying width joined into records, and the
copy of device blocks into the corpus file."""

from __future__ import annotations

import os

import torch

from ..corpus import Corpus, File

_M64 = (1 << 64) - 1


def s64(v: int) -> int:
    """A 64-bit pattern as the signed int64 that torch holds."""
    v &= _M64
    return v - (1 << 64) if v >= 1 << 63 else v


def srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns."""
    return (x >> s) & ((1 << (64 - s)) - 1)


_C1 = s64(0xBF58476D1CE4E5B9)
_C2 = s64(0x94D049BB133111EB)
_GOLD = s64(0x9E3779B97F4A7C15)


def mix(x: torch.Tensor) -> torch.Tensor:
    """splitmix64's finalizer on int64 bit patterns."""
    x = (x ^ srl(x, 30)) * _C1
    x = (x ^ srl(x, 27)) * _C2
    return x ^ srl(x, 31)


def mix_int(v: int) -> int:
    """`mix` of one Python integer, as the 64-bit pattern it gives."""
    return int(mix(torch.tensor([s64(v)], dtype=torch.int64))[0]) & _M64


def stream_key(seed: int, stream: int) -> int:
    """The key of one stream of draws of a seed (a signed int64)."""
    return s64(mix_int(mix_int(seed) + stream * 0x632BE59BD9B4E019))


def draws(key: int, i: torch.Tensor, p=None):
    """Hashed int64 draws (63 bits, never negative) of reads `i` (int64
    [n]) and, with `p` (int64 [w]), of each of their positions: [n] or
    [n, w]."""
    x = i * _GOLD + key
    if p is not None:
        x = x[:, None] + (p + 1)[None, :] * _C2
    return srl(mix(x), 1)


def uniform(d: torch.Tensor) -> torch.Tensor:
    """Draws as float64 in [0, 1)."""
    return srl(d, 10).to(torch.float64) * (2.0 ** -53)


def digits(v: torch.Tensor, width: int, pad: bool):
    """Decimal digits of v (int64 [n], 0 <= v < 10**width) as uint8
    [n, width] left-aligned, with each row's digit count (int64 [n]):
    `pad` zero-pads every row to `width`."""
    n = v.shape[0]
    if pad:
        nd = torch.full((n,), width, dtype=torch.int64, device=v.device)
    else:
        nd = torch.ones(n, dtype=torch.int64, device=v.device)
        for d in range(1, width):
            nd += (v >= 10 ** d).to(torch.int64)
    k = torch.arange(width, device=v.device)[None, :]
    power = torch.tensor([10 ** e for e in range(width)], dtype=torch.int64,
                         device=v.device)
    e = (nd[:, None] - 1 - k).clamp(min=0)
    out = (v[:, None] // power[e] % 10 + 48).to(torch.uint8)
    return torch.where(k < nd[:, None], out, 0).to(torch.uint8), nd


def const(text: bytes, n: int, device):
    """A constant piece: uint8 [n, len(text)] and its widths."""
    row = torch.frombuffer(bytearray(text), dtype=torch.uint8).to(device)
    return (row[None, :].expand(n, -1),
            torch.full((n,), len(text), dtype=torch.int64, device=device))


def join(pieces):
    """Rows of pieces [(uint8 [n, w_k], widths int64 [n])] joined left to
    right, each cut to its width: (uint8 [n, sum w_k], row widths)."""
    n = pieces[0][0].shape[0]
    dev = pieces[0][0].device
    total = sum(m.shape[1] for m, _ in pieces)
    out = torch.zeros((n, total + 1), dtype=torch.uint8, device=dev)
    at = torch.zeros(n, dtype=torch.int64, device=dev)
    for m, w in pieces:
        k = torch.arange(m.shape[1], device=dev)[None, :]
        col = torch.where(k < w[:, None], at[:, None] + k, total)
        out.scatter_(1, col, m.contiguous())
        at = at + w
    return out[:, :total], at


def flat_rows(rows: torch.Tensor, widths: torch.Tensor) -> torch.Tensor:
    """The rows' first `widths` bytes, concatenated in row order."""
    k = torch.arange(rows.shape[1], device=rows.device)[None, :]
    return rows[k < widths[:, None]]


def write_blocks(name: str, reads: int, block: int, sizes, make) -> Corpus:
    """A corpus file of `reads` records made `block` reads at a time:
    `sizes(lo, hi)` gives the records' byte sizes (int64 tensor), and
    `make(lo, hi)` their bytes (uint8 tensor, any device) and a dict of
    planted counts that add over blocks."""
    total = 0
    for lo in range(0, reads, block):
        total += int(sizes(lo, min(reads, lo + block)).sum())
    f = File(name, in_memory=False)
    at = 0
    planted = {}
    try:
        for lo in range(0, reads, block):
            data, counts = make(lo, min(reads, lo + block))
            f.write_at(at, data.cpu().numpy())
            at += data.numel()
            for key, v in counts.items():
                planted[key] = planted.get(key, 0) + int(v)
        if at != total:
            raise AssertionError("generator sized %d bytes, made %d"
                                 % (total, at))
        # on the disk before set-up starts, so that no write-back of the
        # corpus runs beside the timed requests
        os.fsync(f.fd)
    except BaseException:
        f.close()
        raise
    return Corpus(file=f, reads=reads, nbytes=total, planted=planted)
