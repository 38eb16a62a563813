"""The padded-batch analysis step (counterpart of the no-mesh form of
blazeseq_tpu/parallel/pipeline.py::build_qc_align_step).

Validate + decode (ops/validate.py), then `qc_stats` with the error codes,
then, with alignment, the global alignment score of every row against the
reference (ops/nw.py). Mesh sharding is a later slice of the port.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..ops import nw as nw_ops
from ..ops import stats as stats_ops
from ..ops import validate as validate_ops


class QCAlignResult(NamedTuple):
    stats: stats_ops.QCStats
    error_codes: torch.Tensor  # int32[n] per-record validation codes
    phred: torch.Tensor  # u8[n, L] decoded scores
    nw_scores: torch.Tensor  # int32[n] scores against the reference


def _local_step(seq, qual, lengths, n_records, schema, ref=None, *,
                check_ascii: bool, check_quality: bool, with_alignment: bool,
                qual_hist_2d: bool):
    codes, phred = validate_ops.validate_decode(
        seq, qual, lengths, schema, check_ascii=check_ascii,
        check_quality=check_quality)
    st = stats_ops.qc_stats(seq, qual, lengths, int(schema.OFFSET),
                            n_records=n_records, error_codes=codes,
                            qual_hist_2d=qual_hist_2d)
    if with_alignment:
        if ref is None:
            raise ValueError("the alignment step needs a reference")
        # lengths may exceed the padded width for clamped long reads
        scores = nw_ops.nw_scores(
            seq, torch.clamp(lengths, max=seq.shape[1]), ref)
    else:
        scores = torch.zeros(seq.shape[0], dtype=torch.int32,
                             device=seq.device)
    return QCAlignResult(st, codes, phred, scores)


def build_qc_align_step(mesh=None, *, check_ascii: bool = True,
                        check_quality: bool = True,
                        with_alignment: bool = False,
                        qual_hist_2d: bool = False):
    """Build the analysis step.

    Returns fn(seq u8[n, L], qual u8[n, L], lengths int32[n], n_records,
    schema, ref=None) -> QCAlignResult, where `schema` is the QualitySchema
    whose LOWER / UPPER / OFFSET bound and decode the quality bytes, and
    `ref` (u8[Lr] on the batch's device) is the reference the rows are
    aligned to when `with_alignment`; without it the scores are zeros."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh sharding is not ported yet (ROADMAP Queue 1, multi-GPU)")
    return functools.partial(_local_step, check_ascii=check_ascii,
                             check_quality=check_quality,
                             with_alignment=with_alignment,
                             qual_hist_2d=qual_hist_2d)
