"""Share of the bytes fed to a device step whose results were thrown
away, over the traced requests (%): the program's counters
`qc.discarded_bytes` (a failed proof's chunk and those dispatched behind
it; a histogram re-run's whole first pass) over `qc.dispatched_bytes`.
Moves qc_gbps."""

from ._spans import counted, requests


def read(ctx):
    reqs = requests(ctx)
    if reqs is None:
        return None
    fed = counted(reqs, "qc.dispatched_bytes")
    if not fed:
        return None
    return 100.0 * counted(reqs, "qc.discarded_bytes") / fed
