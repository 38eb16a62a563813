"""Streaming QC model of the PyTorch port."""

from .qc import QCModel, QCReport

__all__ = ["QCModel", "QCReport"]
