"""Shared helpers for the device ops (counterpart of
blazeseq_tpu/ops/common.py)."""

from __future__ import annotations

import torch

# the structural bytes of a FASTQ record
NEWLINE = 10
AT = 64
PLUS = 43


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def length_mask(lengths: torch.Tensor, width: int,
                col_offset=0) -> torch.Tensor:
    """[n, width] bool mask of valid positions given per-record lengths.
    `col_offset` shifts the position base: a batch that holds columns
    [col_offset, col_offset + width) of longer records masks against the
    records' true lengths."""
    pos = torch.arange(width, dtype=torch.int64, device=lengths.device)
    return (pos[None, :] + col_offset) < lengths[:, None].to(torch.int64)


def check_cuda_batch(who: str, rows, ints) -> None:
    """Raise unless the tensors are contiguous and on one CUDA device:
    `rows`, (name, tensor) pairs, u8 [n, L] of one shape; `ints` int32 [n].
    A None tensor is skipped. The kernels' wrappers call this before they
    load the library."""
    named = ([(k, t, torch.uint8) for k, t in rows]
             + [(k, t, torch.int32) for k, t in ints if t is not None])
    for name, t, dt in named:
        if not t.is_cuda:
            raise ValueError("%s: %s is not on a CUDA device (got %s)"
                             % (who, name, t.device))
        if t.dtype != dt:
            raise TypeError("%s: %s must be %s, got %s"
                            % (who, name, dt, t.dtype))
        if not t.is_contiguous():
            raise ValueError("%s: %s must be contiguous" % (who, name))
    seq = rows[0][1]
    if seq.dim() != 2 or any(t.shape != seq.shape for _, t in rows):
        raise ValueError("%s: %s must %s [n, L], got %s" % (
            who, " and ".join(k for k, _ in rows),
            "both be" if len(rows) == 2 else "be",
            " and ".join(str(tuple(t.shape)) for _, t in rows)))
    for name, t, _ in named[len(rows):]:
        if t.shape != (seq.shape[0],):
            raise ValueError("%s: %s must be [n], got %s"
                             % (who, name, tuple(t.shape)))
    if len({t.device for _, t, _ in named}) != 1:
        raise ValueError("%s: inputs on different devices" % who)


# the kernels' scratch, kept by (name, device, stream) for the stream's
# later calls and zeroed once: csrc/tiles.cu's int64 sums and tickets,
# which every launch leaves zero, and csrc/kmer.cu's start-ticket state,
# which every launch leaves ready for the next
_KEPT = {}


def _kept(name, device, stream, numel, dtype):
    """A zeroed 1-D tensor of at least numel elements on `device`, made
    anew only to grow."""
    key = (name, device.index, stream)
    have = _KEPT.get(key)
    if have is None or have.numel() < numel:
        size = max(numel, 1 if have is None else 2 * have.numel())
        have = torch.zeros(size, dtype=dtype, device=device)
        _KEPT[key] = have
    return have


def resolve_device(device, who: str) -> torch.device:
    """The torch device a model runs on. "cuda" needs a CUDA card and raises
    without one; "cpu" (the plain torch versions of the kernels) must be
    asked for by name; anything else raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "%s(device=%r): CUDA is not available; pass device='cpu' to run "
            "the plain torch path" % (who, str(device)))
    if dev.type not in ("cuda", "cpu"):
        raise ValueError("%s: unsupported device %r" % (who, str(device)))
    return dev
