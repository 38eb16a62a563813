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
