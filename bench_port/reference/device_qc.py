"""Reference of the device_qc route: every leaf of the QC report of the
file, exact, from the generated bytes."""

from __future__ import annotations

import torch

from . import _fastq as fq

# the report leaves that run_file_device returns
CORE = ("reads", "bases", "error_reads", "gc_fraction", "mean_quality",
        "base_counts", "per_position_mean_quality", "qual_hist",
        "length_hist", "gc_hist", "mean_qual_hist", "per_pos_base_counts",
        "per_pos_count")


def totals(corpus, config, params, device, dtype=torch.int64,
           quality_hist_2d=False):
    """The panels' sums over the corpus (see _fastq.qc_totals)."""
    data = fq.to_device(corpus.file.array(), device)
    corpus.file.release()
    recs = fq.records(data)
    return fq.qc_totals(
        data, recs, width=int(params["max_read_len"]),
        offset=int(config["quality_offset"]),
        lower=int(config["quality_lower"]), upper=int(config["quality_upper"]),
        quality_hist_2d=quality_hist_2d, dtype=dtype)


def expected(corpus, config, params, device, dtype=torch.int64) -> dict:
    tot = totals(corpus, config, params, device, dtype)
    return fq.core_report(tot, int(params["max_read_len"]))


def differing(report, want: dict, names=CORE) -> list:
    """The names of the leaves in which a report differs."""
    return [k for k in names
            if not fq.leaves_equal(getattr(report, k, None), want[k])]


def judge(answers, want: dict) -> dict:
    """The numbers compared, each (value, limit): the most leaves any
    request's report got wrong, and how many requests got any wrong."""
    bad = [differing(rep, want) for rep in answers]
    return dict(leaves_differing=(max(len(b) for b in bad), 0),
                requests_wrong=(sum(1 for b in bad if b), 0))
