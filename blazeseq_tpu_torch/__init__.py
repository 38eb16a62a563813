"""blazeseq_tpu_torch: the PyTorch + CUDA port of blazeseq_tpu.

The device layer runs on torch tensors, with hand-written Hopper kernels
(``csrc/``) where the reference had Pallas kernels; the host layer (readers,
parser, quality schemas, native scanner) is imported from ``blazeseq_tpu``
unchanged and loads no JAX. Entry points::

    from blazeseq_tpu_torch import NWAligner, QCModel
    report = QCModel(quality_schema="sanger").run_file_device("reads.fastq")
    report = QCModel(quality_schema="sanger", align_to=ref).run_file(path)
    scores = NWAligner(ref).score_padded(padded_batch)

The device ops (the device-parse API, trimming, k-mers, tiles, demux,
merge) are in ``blazeseq_tpu_torch.ops`` under the reference's names, and
``python -m blazeseq_tpu_torch`` is the command line.
"""

from .models.aligner import NWAligner
from .models.qc import QCModel, QCReport

__all__ = ["NWAligner", "QCModel", "QCReport"]
