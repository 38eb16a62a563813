"""The readers of the program's spans and counters (metrics/_spans.py and
the metrics that use it) on each listed cell's CPU run at a tiny size:
a traced run reports each of them, finite and not negative; an untraced
run reports none; a program that keeps no requests gives none and raises
nothing.

    python -m pytest bench_port -q
"""

from __future__ import annotations

import math
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from bench_port import harness  # noqa: E402

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]
# the readers of metrics/_spans.py
SPAN_READERS = {"host_feed_s_per_gb.qc", "feed_wait_s_per_gb.qc",
                "discarded_pct.qc", "parse_us_per_read.panels",
                "upload_us_per_read.panels", "enqueue_us_per_batch.panels"}
READS = 2500
SEED = 2 ** 31 + 777


def _readers(cell):
    return {m["name"] for m in harness.metrics_of(cell, "per_layer")
            if m["name"] in SPAN_READERS}


def _run(cell, trace):
    return harness.run(cell, SEED, 0.3, trace, device="cpu", reads=READS,
                       log=lambda s: None)


def test_every_span_reader_is_listed():
    assert set().union(*map(_readers, CELLS)) == SPAN_READERS


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_every_span_reader(cell):
    r = _run(cell, trace=True)
    assert r["correct"] is True
    got = {k: v["value"] for k, v in r["metrics"].items()}
    for name in _readers(cell):
        assert name in got, name
        assert math.isfinite(got[name]) and got[name] >= 0, (name, got)
    if cell == "device_qc.throughput_100bp":
        # one layout from the first record to the last: no proof fails, and
        # the head holds every Phred value, so nothing runs twice
        assert got["discarded_pct.qc"] == 0.0


@pytest.mark.parametrize("cell", CELLS)
def test_untraced_run_reports_none(cell):
    r = _run(cell, trace=False)
    assert not _readers(cell) & set(r["metrics"])


@pytest.mark.parametrize("cell", CELLS)
def test_a_program_without_requests_gives_none(monkeypatch, cell):
    from blazeseq_tpu_torch import tracing

    monkeypatch.delattr(tracing.Tracer, "requests")
    r = _run(cell, trace=True)
    assert r["correct"] is True
    assert not _readers(cell) & set(r["metrics"])
