"""blazeseq_tpu_torch: the PyTorch + CUDA port of blazeseq_tpu.

The device layer runs on torch tensors, with hand-written Hopper kernels
(``csrc/``) where the reference had Pallas kernels; the host layer (readers,
parser, quality schemas, native scanner) is imported from ``blazeseq_tpu``
unchanged and loads no JAX. Entry point::

    from blazeseq_tpu_torch import QCModel
    report = QCModel(quality_schema="sanger").run_file_device("reads.fastq")
"""

from .models.qc import QCModel, QCReport

__all__ = ["QCModel", "QCReport"]
