"""Route `cli`: one command of the port's CLI, called in-process as
blazeseq_tpu_torch.__main__.main(argv) with its stdout captured. The
traffic's `argv` names the input as {path} and the output file as {out}.
Every request's printed line is kept for the check. One request, drawn
from the seed among the window's first three, writes into an in-memory
file whose bytes are checked; the others write to the null device: on
the chip machine (a gVisor sandbox) writing the output into a memory
file took 4.2-4.7 s of a 5.1-5.9 s traced stretch of two requests, the
sandbox's cost and not the port's (PERF.md), and a disk file would write
tens of GiB a run."""

from __future__ import annotations

import contextlib
import io
import os
import random

import torch

from ..corpus import File
from ._port import launch_counters


class Route:
    def __init__(self, cell, corpus, device, seed):
        self.cell, self.corpus, self.device = cell, corpus, device
        self.kept_index = 1 + random.Random(seed).randrange(3)
        # the window runs at least up to the kept request
        self.min_requests = self.kept_index
        self._kept = File("cli_out", in_memory=True)
        self._answers = []
        self._main = None

    def setup(self) -> None:
        from blazeseq_tpu_torch.__main__ import main

        self._main = main

    def request(self, index: int, keep: bool):
        kept = index == self.kept_index
        if kept:
            self._kept.clear()
        argv = [a.format(path=self.corpus.path,
                         out=self._kept.path if kept else os.devnull)
                for a in self.cell.params["argv"]]
        text = io.StringIO()
        with torch.profiler.record_function("entry.cli"), \
                contextlib.redirect_stdout(text):
            rc = self._main(["--torch-device", str(self.device)] + argv)
        if rc != 0:
            raise RuntimeError("the command exited with %r: %s"
                               % (rc, text.getvalue()))
        if keep:
            self._answers.append(dict(stdout=text.getvalue(), kept=kept))
        return dict(bytes=self.corpus.nbytes, reads=self.corpus.reads), {}

    def launches(self) -> dict:
        return launch_counters()

    def answers(self) -> list:
        """Each request's printed line, with the written bytes of the
        kept request."""
        return [dict(stdout=a["stdout"],
                     output=self._kept.read() if a["kept"] else None)
                for a in self._answers]

    def close(self) -> None:
        self._main = None
        self._kept.close()
