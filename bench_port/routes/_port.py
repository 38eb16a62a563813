"""What the routes share: the port's launch counters, and the QC routes'
request loop around one QCModel entry."""

from __future__ import annotations

import importlib
import pkgutil

import torch


def launch_counters() -> dict:
    """{name: launches} of every op wrapper of blazeseq_tpu_torch.ops that
    counts its kernel launches (a `.launches` attribute)."""
    ops = importlib.import_module("blazeseq_tpu_torch.ops")
    out = {}
    for info in pkgutil.iter_modules(ops.__path__):
        mod = importlib.import_module("blazeseq_tpu_torch.ops." + info.name)
        for name, fn in vars(mod).items():
            n = getattr(fn, "launches", None)
            if callable(fn) and isinstance(n, int):
                out[name] = n
    return out


class QCRoute:
    """One QCModel, built once; a request is one call of its `ENTRY` on
    the whole file, and the report is kept for the check."""

    ENTRY = ""
    min_requests = 1  # the window's least number of requests

    def __init__(self, cell, corpus, device, seed):
        self.cell, self.corpus, self.device = cell, corpus, device
        self.model = None
        self._answers = []

    def model_args(self) -> dict:
        """QCModel's arguments beside the schema, width and device."""
        return {}

    def info(self) -> dict:
        """What a request did, for the run's log and the readers."""
        return {}

    def setup(self) -> None:
        from blazeseq_tpu_torch import QCModel

        self.model = QCModel(
            quality_schema=self.cell.config["quality_schema"],
            max_read_len=int(self.cell.params["max_read_len"]),
            device=self.device, **self.model_args())

    def request(self, index: int, keep: bool):
        """One whole request: (work, info)."""
        with torch.profiler.record_function("entry." + self.ENTRY):
            rep = getattr(self.model, self.ENTRY)(self.corpus.path)
        if keep:
            self._answers.append(rep)
        return (dict(bytes=self.corpus.nbytes, reads=self.corpus.reads),
                self.info())

    def launches(self) -> dict:
        return launch_counters()

    def answers(self) -> list:
        return self._answers

    def close(self) -> None:
        self.model = None
