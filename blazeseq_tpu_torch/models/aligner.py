"""NWAligner: batched alignment of reads against one reference (counterpart
of blazeseq_tpu/models/aligner.py).

Padded batches go to the device, each read is scored against the
reference, and `verify_batch` holds the scores against the numpy scalar
twins. mode="global" without `gap_open` runs the Needleman-Wunsch kernel
(ops/nw.py::nw_scores); the local, semi-global and affine-gap modes run
their torch wavefronts.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from blazeseq_tpu.fastq.batch import FastqBatch, PaddedFastqBatch

from ..ops import nw as nw_ops
from ..ops.common import resolve_device

MAX_QUERY_LEN = 256  # the reference example's clamp

_MODES = ("global", "local", "semiglobal")
_LINEAR = {"global": nw_ops.nw_scores, "local": nw_ops.sw_scores,
           "semiglobal": nw_ops.nw_semiglobal_scores}
_AFFINE = {"global": nw_ops.nw_affine_scores,
           "local": nw_ops.sw_affine_scores,
           "semiglobal": nw_ops.nw_semiglobal_affine_scores}
_LINEAR_TWINS = {"global": nw_ops.needleman_wunsch_cpu,
                 "local": nw_ops.smith_waterman_cpu,
                 "semiglobal": nw_ops.semiglobal_cpu}
_AFFINE_TWINS = {"global": nw_ops.needleman_wunsch_affine_cpu,
                 "local": nw_ops.smith_waterman_affine_cpu,
                 "semiglobal": nw_ops.semiglobal_affine_cpu}


class NWAligner:
    """Scores reads against `reference`.

    mode="global" is Needleman-Wunsch, "local" Smith-Waterman, and
    "semiglobal" aligns the whole read with free leading and trailing
    reference bases. gap_open=None keeps the linear gap model (every gapped
    base costs -1); a gap_open (e.g. -3) switches to affine gaps, where a
    length-k gap costs gap_open + (k-1) * gap_extend.

    `device` follows QCModel: "cuda" (the default) raises without CUDA,
    "cpu" runs the plain torch versions and must be asked for by name. The
    reference is uploaded once, here."""

    def __init__(self, reference: bytes, max_query_len: int = MAX_QUERY_LEN,
                 mode: str = "global", gap_open: Optional[int] = None,
                 gap_extend: int = -1, device="cuda"):
        if mode not in _MODES:
            raise ValueError(
                "mode must be 'global', 'local', or 'semiglobal'")
        self.device = resolve_device(device, "NWAligner")
        self.reference = bytes(reference)
        self._ref = torch.from_numpy(np.frombuffer(
            self.reference, np.uint8).copy()).to(self.device)
        self.max_query_len = max_query_len
        self.mode = mode
        self.gap_open = gap_open
        self.gap_extend = gap_extend

    def _step(self, seq, lengths):
        mql = self.max_query_len
        lengths = torch.clamp(lengths.to(torch.int32), max=mql)
        if seq.shape[1] > mql:
            seq = seq[:, :mql].contiguous()
        # a row narrower than a true read length scores its clamped prefix
        lengths = torch.clamp(lengths, max=seq.shape[1])
        if self.gap_open is not None:
            return _AFFINE[self.mode](seq, lengths, self._ref,
                                      gap_open=self.gap_open,
                                      gap_extend=self.gap_extend)
        return _LINEAR[self.mode](seq, lengths, self._ref)

    def score_padded(self, pb: PaddedFastqBatch) -> np.ndarray:
        """int32 scores of the batch's first n_records rows."""
        seq = torch.from_numpy(np.ascontiguousarray(pb.seq)).to(self.device)
        lengths = torch.from_numpy(
            np.asarray(pb.lengths, dtype=np.int32)).to(self.device)
        return self._step(seq, lengths)[: pb.n_records].cpu().numpy()

    def score_batch(self, batch: FastqBatch) -> np.ndarray:
        # the width is sized to the batch; _step slices it to max_query_len
        return self.score_padded(batch.to_padded())

    def score_cpu(self, batch: FastqBatch) -> np.ndarray:
        """Scores from the numpy scalar twins, read by read."""
        if self.gap_open is not None:
            base = _AFFINE_TWINS[self.mode]

            def twin(q, r):
                return base(q, r, gap_open=self.gap_open,
                            gap_extend=self.gap_extend)
        else:
            twin = _LINEAR_TWINS[self.mode]
        out = np.empty(len(batch), dtype=np.int32)
        for i in range(len(batch)):
            q = batch.get_ref(i).sequence_bytes()[: self.max_query_len]
            out[i] = twin(q, self.reference)
        return out

    def verify_batch(self, batch: FastqBatch) -> bool:
        """Device scores equal the scalar twins' on every read."""
        return bool(np.array_equal(self.score_batch(batch),
                                   self.score_cpu(batch)))
