"""Models of the PyTorch port: streaming QC and read alignment."""

from .aligner import NWAligner
from .qc import QCModel, QCReport

__all__ = ["NWAligner", "QCModel", "QCReport"]
