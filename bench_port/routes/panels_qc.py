"""Route `panels_qc`: QCModel(adapters, track_duplicates,
track_quartiles).run_file(path), the host parser's padded batches and the
FastQC panel kernels, on the whole file."""

from __future__ import annotations

from ._port import QCRoute


class Route(QCRoute):
    ENTRY = "run_file"

    def model_args(self) -> dict:
        p = self.cell.params
        return dict(batch_size=int(p["batch_size"]),
                    adapters=[a.encode("ascii") for a in p["adapters"]],
                    track_duplicates=bool(p["track_duplicates"]),
                    dup_track_limit=int(p["dup_track_limit"]),
                    track_quartiles=bool(p["track_quartiles"]))
