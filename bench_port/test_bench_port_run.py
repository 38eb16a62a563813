"""Each cell's run end to end on the CPU path at a tiny size (the
command itself refuses to run without a card), its result line, and
`correct` coming out false when the timed path is broken underneath.

    python -m pytest bench_port -q
"""

from __future__ import annotations

import json
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from bench_port import harness  # noqa: E402

# every cell with files, the ones BENCHMARK.json lists and those kept for
# a later benchmark (PERF.md, Open questions)
CELLS = sorted(f[:-len(".json")] for f in os.listdir(
    os.path.join(ROOT, "bench_port", "workloads")) if f.endswith(".json"))
READS = 2500
SEED = 2 ** 31 + 12345  # past 32 signed bits, as the driver's seeds are


def _run(cell, trace=False, reads=READS):
    return harness.run(cell, SEED, 0.3, trace, device="cpu", reads=reads,
                       log=lambda s: None)


@pytest.mark.parametrize("cell", CELLS)
def test_result_line(cell):
    r = _run(cell)
    assert list(r) == ["correct", "attempted", "failed", "metrics",
                       "device", "compared"]
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    want = {m["name"]: m["unit"] for m in harness.metrics_of(cell,
                                                            "end_to_end")}
    assert {k: v["unit"] for k, v in r["metrics"].items()} == want
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert set(r["device"]) == {"platform", "kind", "count",
                                "memory_peak_bytes"}
    assert all(v["value"] <= v["limit"] for v in r["compared"].values())
    json.dumps(r)


@pytest.mark.parametrize("cell", CELLS)
def test_traced_result_line(cell):
    r = _run(cell, trace=True)
    assert r["correct"] is True
    names = {m["name"] for m in harness.metrics_of(cell, "per_layer")}
    # the CPU path has no device trace: only host readings are there
    assert set(r["metrics"]) <= names
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(r)[-1] == "compared"


def _break(monkeypatch, cell, fault):
    """Plant `fault` under the cell's timed path."""
    route = harness.Cell.load(cell).route
    if route == "cli":
        from blazeseq_tpu_torch.ops import trim

        real = trim.sliding_window_trim_torch

        def broken(qual, lengths, *a, **k):
            new = real(qual, lengths, *a, **k)
            if fault == "half_left_out":
                new[new.shape[0] // 2:] = 0
            elif fault == "state_unchanged":  # the lengths come back as given
                new = lengths.to(new.dtype).clamp(max=qual.shape[1])
            else:  # one answer altered where it is produced
                new[0] = max(int(new[0]) - 1, 0)
            return new

        monkeypatch.setattr(trim, "sliding_window_trim_torch", broken)
        return
    from blazeseq_tpu_torch.models import qc
    from blazeseq_tpu_torch.ops import stats

    if fault == "half_left_out":
        if route == "device_qc":
            real_uqc = qc.uniform_qc

            def uqc(chunk, n_valid, *, rs, **k):
                return real_uqc(chunk, n_valid // rs // 2 * rs, rs=rs, **k)

            monkeypatch.setattr(qc, "uniform_qc", uqc)
        else:
            real_build = qc.build_qc_align_step

            def build(*a, **k):
                step = real_build(*a, **k)

                def half(seq, qual, lengths, n_records, *r, **kw):
                    return step(seq, qual, lengths, n_records // 2, *r, **kw)

                return half

            monkeypatch.setattr(qc, "build_qc_align_step", build)
        return
    real_add = stats.QCAccumulator.add

    def add(self, st):
        if fault == "state_unchanged":  # the totals come back as they were
            if self.total is None:
                real_add(self, stats.QCStats(*(
                    None if a is None else a * 0 for a in st)))
            return
        real_add(self, st)  # one count altered where the totals are made
        self.total.qual_hist[0] += 1

    monkeypatch.setattr(stats.QCAccumulator, "add", add)


@pytest.mark.parametrize("fault", ["half_left_out", "state_unchanged",
                                   "answer_altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_path_is_not_correct(monkeypatch, cell, fault):
    _break(monkeypatch, cell, fault)
    r = _run(cell)
    assert r["correct"] is False
    assert any(v["value"] > v["limit"] for v in r["compared"].values())


def test_a_big_seed_gives_the_same_bytes_twice():
    cell = harness.Cell.load("device_qc.novaseq_150bp")
    gen = harness.load_module("gen", cell.config["name"])
    a = gen.generate(cell.config, SEED, torch.device("cpu"), reads=300)
    b = gen.generate(cell.config, SEED, torch.device("cpu"), reads=300)
    c = gen.generate(cell.config, SEED + 1, torch.device("cpu"), reads=300)
    try:
        assert (a.file.read() == b.file.read()).all()
        assert a.file.read().tobytes() != c.file.read().tobytes()
    finally:
        for x in (a, b, c):
            x.file.close()
