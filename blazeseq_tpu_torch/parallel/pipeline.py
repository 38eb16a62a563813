"""The padded-batch analysis step (counterpart of the no-mesh form of
blazeseq_tpu/parallel/pipeline.py::build_qc_align_step).

Validate + decode (ops/validate.py), then `qc_stats` with the error codes.
Alignment scores are zeros: alignment and mesh sharding are later slices of
the port.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..ops import stats as stats_ops
from ..ops import validate as validate_ops


class QCAlignResult(NamedTuple):
    stats: stats_ops.QCStats
    error_codes: torch.Tensor  # int32[n] per-record validation codes
    phred: torch.Tensor  # u8[n, L] decoded scores
    nw_scores: torch.Tensor  # int32[n], zeros until alignment is ported


def _local_step(seq, qual, lengths, n_records, schema, *, check_ascii: bool,
                check_quality: bool):
    codes, phred = validate_ops.validate_decode(
        seq, qual, lengths, schema, check_ascii=check_ascii,
        check_quality=check_quality)
    st = stats_ops.qc_stats(seq, qual, lengths, int(schema.OFFSET),
                            n_records=n_records, error_codes=codes)
    scores = torch.zeros(seq.shape[0], dtype=torch.int32, device=seq.device)
    return QCAlignResult(st, codes, phred, scores)


def build_qc_align_step(mesh=None, *, check_ascii: bool = True,
                        check_quality: bool = True,
                        with_alignment: bool = False):
    """Build the analysis step.

    Returns fn(seq u8[n, L], qual u8[n, L], lengths int32[n], n_records,
    schema) -> QCAlignResult, where `schema` is the QualitySchema whose
    LOWER / UPPER / OFFSET bound and decode the quality bytes."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh sharding is not ported yet (ROADMAP Queue 1, multi-GPU)")
    if with_alignment:
        raise NotImplementedError(
            "alignment is not ported yet (ROADMAP Queue 1, alignment)")
    return functools.partial(_local_step, check_ascii=check_ascii,
                             check_quality=check_quality)
