"""What the per-layer readers share: the traced stretch's device shares,
the read lengths and adapter hits of the corpus (from the reference's
plain reader), and the card's peaks. A reader that finds nothing to read
returns None."""

from __future__ import annotations

import numpy as np
import torch

from ..reference import _fastq as fq
from ..reference.panels_qc import first_hits
from ..roofline import peaks


def traced(ctx):
    """The traced stretch's summary, when the card was traced."""
    t = ctx.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return t


def idle_pct(ctx):
    t = traced(ctx)
    return None if t is None else 100.0 * (1.0 - t.busy_s / t.window_s)


def h2d_gbps(ctx):
    t = traced(ctx)
    if t is None or t.h2d_s <= 0:
        return None
    return t.h2d_bytes / t.h2d_s / 1e9


def card(ctx):
    """(SM count, largest SM clock in Hz) of the card, or None off it."""
    if ctx.device.type != "cuda":
        return None
    if "card" not in ctx.cache:
        sms = torch.cuda.get_device_properties(ctx.device).multi_processor_count
        ctx.cache["card"] = (sms, peaks.sm_clock_hz())
    return ctx.cache["card"]


def share_pct(ctx, bound_seconds: float, kernel_seconds: float):
    """100 * bound / time, or None without a time or a card."""
    c = card(ctx)
    if c is None or kernel_seconds <= 0:
        return None
    return 100.0 * bound_seconds / kernel_seconds


def bound(ctx, n_bytes, ops) -> float:
    sms, clock = card(ctx)
    return peaks.bound_s(n_bytes, ops, sms, clock)


def _records(ctx):
    if "records" not in ctx.cache:
        data = fq.to_device(ctx.corpus.file.array(), ctx.device)
        ctx.corpus.file.release()
        ctx.cache["records"] = (data, fq.records(data))
    return ctx.cache["records"]


def lengths(ctx) -> np.ndarray:
    """Every read's length, in file order."""
    if "lengths" not in ctx.cache:
        ctx.cache["lengths"] = _records(ctx)[1].seq_len.cpu().numpy()
    return ctx.cache["lengths"]


def adapter_scan_work(ctx, adapters, width: int):
    """Per read, how far the multi-adapter scan must read (the end of the
    last adapter's first hit, or the read's length within `width` where an
    adapter has none), and the start columns it must test (up to each
    adapter's first hit): two int64 arrays."""
    data, recs = _records(ctx)
    upto, starts = [], []
    for _, _, fit, hits in first_hits(data, recs, adapters, width):
        read = torch.zeros_like(fit)
        tested = torch.zeros_like(fit)
        for a, (anyhit, first) in zip(adapters, hits):
            la = len(a)
            tested += torch.where(anyhit, first + 1,
                                  (fit - la + 1).clamp(min=0))
            read = torch.maximum(read, torch.where(anyhit, first + la, fit))
        upto.append(read.cpu().numpy())
        starts.append(tested.cpu().numpy())
    return np.concatenate(upto), np.concatenate(starts)


def batches(n: int, size: int):
    """[lo, hi) of the consecutive batches of `size` records."""
    return [(lo, min(n, lo + size)) for lo in range(0, n, size)]


def host_cpu(ctx, per: str, scale: float):
    """Process CPU seconds over the untraced requests, per unit of their
    work (`per`: "bytes" or "reads"), times `scale`."""
    r = ctx.rusage
    if not r or not r.get(per):
        return None
    return r["cpu_s"] / r[per] * scale
