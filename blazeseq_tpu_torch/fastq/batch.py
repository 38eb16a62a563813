"""Device upload of FASTQ batches (counterpart of the device half of
blazeseq_tpu/fastq/batch.py).

The host batch classes belong to the reference and stay as they are, so
the port offers functions beside them: `upload_batch_to_device` gives a
`DeviceFastqBatch` of flat SoA tensors, and `padded_to_device` gives a
`PaddedFastqBatch` whose rows are tensors. Ids stay on the host.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List

import numpy as np
import torch

from blazeseq_tpu.fastq.batch import FastqBatch, PaddedFastqBatch
from blazeseq_tpu.fastq.record import FastqRecord

from ..ops.common import resolve_device


@dataclass
class DeviceFastqBatch:
    """Flat SoA batch on a torch device."""

    seq: torch.Tensor  # u8[total]
    qual: torch.Tensor  # u8[total]
    ends: torch.Tensor  # i64[n] record end offsets into seq / qual
    quality_offset: int
    id_bytes: np.ndarray  # host
    id_ends: np.ndarray  # host

    def num_records(self) -> int:
        return int(self.ends.shape[0])

    def copy_to_host(self) -> FastqBatch:
        """Download the tensors back into a host batch equal to the one
        uploaded."""
        return FastqBatch.from_arrays(
            self.seq.cpu().numpy(), self.qual.cpu().numpy(),
            self.ends.cpu().numpy(), self.id_bytes, self.id_ends,
            self.quality_offset)

    def to_records(self) -> List[FastqRecord]:
        return self.copy_to_host().to_records()


def _put(a, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def upload_batch_to_device(batch: FastqBatch,
                           device="cuda") -> DeviceFastqBatch:
    """Upload a host batch's flat sequence, quality and end arrays to
    `device` ("cuda" needs a card and raises without one)."""
    dev = resolve_device(device, "upload_batch_to_device")
    batch._finalize()
    return DeviceFastqBatch(
        seq=_put(batch._sequence_bytes, dev),
        qual=_put(batch._quality_bytes, dev),
        ends=_put(np.asarray(batch._ends, np.int64), dev),
        quality_offset=batch.quality_offset(),
        id_bytes=batch._id_bytes,
        id_ends=batch._id_ends)


def padded_to_device(pb: PaddedFastqBatch, device="cuda") -> PaddedFastqBatch:
    """The padded batch with seq / qual u8[n, L] and lengths i32[n] as
    tensors on `device` ("cuda" needs a card and raises without one)."""
    dev = resolve_device(device, "padded_to_device")
    return replace(pb, seq=_put(pb.seq, dev), qual=_put(pb.qual, dev),
                   lengths=_put(np.asarray(pb.lengths, np.int32), dev))
