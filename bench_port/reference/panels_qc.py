"""Reference of the panels_qc route: the core leaves, the adapter content
of every adapter, the duplication levels and overrepresented sequences of
the first `dup_track_limit` reads, and the per-position quality
distribution with its deciles and quartiles, exact, from the generated
bytes."""

from __future__ import annotations

import numpy as np
import torch

from . import _fastq as fq
from .device_qc import CORE

TOP_K = 20  # the overrepresented sequences the port lists
_PROBS = (0.10, 0.25, 0.50, 0.75, 0.90)


def first_hits(data, recs, adapters, width, block=1 << 20):
    """Per block of records: (lo, hi, fit, [(any hit, first hit column)
    an adapter]): a read's first full match of the adapter, case-folded,
    that ends inside its first `fit` = min(length, width) bases."""
    for lo, hi in fq.blocks(len(recs), block):
        seq, mask = fq.rows(data, recs.seq_start[lo:hi], recs.seq_len[lo:hi],
                            width)
        fit = mask.sum(1)
        up = seq & 0xDF
        hits = []
        for a in adapters:
            la = len(a)
            starts = seq.shape[1] - la + 1
            if starts <= 0:
                none = torch.zeros(hi - lo, dtype=torch.bool,
                                   device=data.device)
                hits.append((none, torch.zeros_like(fit)))
                continue
            hit = torch.ones((hi - lo, starts), dtype=torch.bool,
                             device=data.device)
            for k, b in enumerate(a):
                hit &= up[:, k:k + starts] == (b & 0xDF)
            j = torch.arange(starts, device=data.device)[None, :]
            hit &= j + la <= fit[:, None]
            hits.append((hit.any(1), hit.to(torch.int8).argmax(1)))
        yield lo, hi, fit, hits


def adapter_content(data, recs, adapters, width, dtype=torch.int64):
    """{adapter: (first_occurrence [width], reads_with_adapter,
    reads_scanned)}."""
    adapters = [bytes(a) for a in adapters]
    first = [torch.zeros(width, dtype=dtype, device=data.device)
             for _ in adapters]
    with_hit = [torch.zeros((), dtype=dtype, device=data.device)
                for _ in adapters]
    for _, _, _, hits in first_hits(data, recs, adapters, width):
        for k, (anyhit, pos) in enumerate(hits):
            first[k] += torch.bincount(pos[anyhit], minlength=width)[
                :width].to(dtype)
            with_hit[k] += anyhit.sum().to(dtype)
    return {a: (f.cpu().numpy(), h.cpu().numpy(), len(recs))
            for a, f, h in zip(adapters, first, with_hit)}


def duplication(data, recs, limit, width, max_level=10,
                min_fraction=0.001, prefix=50):
    """FastQC's duplication panel over the first `limit` reads: how many
    distinct sequences (bases in the first `width`, and length) occur k
    times, the share of reads whose sequence occurs once, and the
    sequences above `min_fraction` of the sample with their first
    occurrence's first `prefix` bases."""
    n = min(limit, len(recs))
    seq, _ = fq.rows(data, recs.seq_start[:n], recs.seq_len[:n], width)
    lens = recs.seq_len[:n].cpu().numpy().astype(np.int64)
    host = np.ascontiguousarray(np.concatenate(
        [seq.cpu().numpy(), lens.view(np.uint8).reshape(n, 8)], 1))
    keys = host.view(np.dtype((np.void, host.shape[1]))).reshape(-1)
    _, first, counts = np.unique(keys, return_index=True, return_counts=True)
    levels = np.bincount(np.minimum(counts, max_level),
                         minlength=max_level + 1).astype(np.int64)
    frac = float((counts == 1).sum()) / n if n else 1.0
    hot = (counts > 1) & (counts / max(n, 1) > min_fraction)
    over = sorted(((host[i, :prefix].tobytes().rstrip(b"\0"), int(c))
                   for i, c in zip(first[hot], counts[hot])),
                  key=lambda e: (-e[1], e[0]))
    return levels, frac, over


def quartiles(hist2d: np.ndarray) -> np.ndarray:
    """[5, w] lower empirical deciles and quartiles a position: the least
    Phred v whose cumulative count reaches ceil(p * n), at least 1; 0 where
    a position has no base."""
    cum = np.cumsum(hist2d, axis=0)
    n = cum[-1]
    rows = []
    for p in _PROBS:
        need = np.maximum(np.ceil(p * n).astype(np.int64), 1)
        rows.append(np.where(n > 0, (cum < need[None, :]).sum(0), 0))
    return np.stack(rows)


def expected(corpus, config, params, device, dtype=torch.int64) -> dict:
    width = int(params["max_read_len"])
    data = fq.to_device(corpus.file.array(), device)
    corpus.file.release()
    recs = fq.records(data)
    tot = fq.qc_totals(
        data, recs, width=width, offset=int(config["quality_offset"]),
        lower=int(config["quality_lower"]),
        upper=int(config["quality_upper"]), quality_hist_2d=True,
        dtype=dtype)
    want = fq.core_report(tot, width)
    want["per_pos_qual_hist"] = tot.numpy("per_pos_qual_hist", width)
    want["quality_quartiles"] = quartiles(want["per_pos_qual_hist"])
    want["adapters"] = adapter_content(
        data, recs, [a.encode() for a in params["adapters"]], width,
        dtype=dtype)
    (want["duplication_levels"], want["frac_unique_reads"],
     want["overrepresented"]) = duplication(
        data, recs, int(params["dup_track_limit"]), width)
    return want


def _adapters_equal(got: dict, want: dict) -> bool:
    if got is None or set(got) != set(want):
        return False
    for a, (first, hits, scanned) in want.items():
        st = got[a]
        if not (fq.leaves_equal(st.first_occurrence, first)
                and int(st.reads_with_adapter) == int(hits)
                and int(st.reads_scanned) == int(scanned)):
            return False
    return True


def _overrepresented_equal(got, want) -> bool:
    """The report's list against the reference's: the same entries, most
    frequent first, up to TOP_K (the order of equal counts is free)."""
    got = list(got or [])
    if len(got) != min(TOP_K, len(want)):
        return False
    if [c for _, c in got] != [c for _, c in want[:len(got)]]:
        return False
    return set(got) <= set(want)


def differing(rep, want: dict) -> list:
    bad = [k for k in CORE + ("duplication_levels", "frac_unique_reads",
                              "quality_quartiles", "per_pos_qual_hist")
           if not fq.leaves_equal(getattr(rep, k, None), want[k])]
    if not _adapters_equal(rep.adapter_stats, want["adapters"]):
        bad.append("adapters")
    if not _overrepresented_equal(rep.overrepresented,
                                  want["overrepresented"]):
        bad.append("overrepresented")
    return bad


def judge(answers, want: dict) -> dict:
    bad = [differing(rep, want) for rep in answers]
    return dict(leaves_differing=(max(len(b) for b in bad), 0),
                requests_wrong=(sum(1 for b in bad if b), 0))
