"""Route `device_qc`: QCModel(device).run_file_device(path), the port's
QC of raw bytes on the card (core panels), on the whole file."""

from __future__ import annotations

from ._port import QCRoute


class Route(QCRoute):
    ENTRY = "run_file_device"

    def info(self) -> dict:
        return dict(tier_chunks=dict(self.model.tier_chunks))
