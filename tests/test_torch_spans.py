"""The port's program tracer (blazeseq_tpu_torch/tracing.py) and the spans
and counters that the QC paths open in it.

The tracer: off, `span()` is one shared no-op and nothing is recorded;
under torch.profiler the spans are record-function ranges of the
exported trace, nested as they ran; parents, request ids and self time of
a hand-built nest; a second thread's spans do not nest into the main
thread's; past its bound a span is dropped and counted, and the totals
still count it.

The paths, on the CPU inside `capture()`: run_file_device on a uniform
file, on a uniform head before ids of varying width (a proof fails), and
on a file whose Phred values leave the head's peek (one re-run); on a uniform
file whose last chunk holds a few records and a partial one (on the card
too, at 256 MiB chunks); run_file with FastQC's panels. Every report
equals the one tracing off gives.
"""

from __future__ import annotations

import json
import threading
import time

import numpy as np
import pytest

import blazeseq_tpu_torch as bt
from blazeseq_tpu_torch import QCModel, tracing

FEED_SPANS = {"bs.qc.route", "bs.feed.stage", "bs.feed.wait",
              "bs.feed.dispatch", "bs.qc.accumulate", "bs.qc.report"}


@pytest.fixture
def fresh():
    """The program's tracer, emptied before and after the test."""
    t = tracing.global_tracer()
    t.reset()
    yield t
    t.reset()


def _uniform(n, L):
    return bytes(bt.generate_synthetic_fastq_buffer(n, L, L, 2, 40,
                                                    "sanger"))


def _var_ids(n, L, seed):
    return bytes(bt.generate_variable_id_fastq_buffer(n, L, L, 2, 40,
                                                      "sanger", seed=seed))


def _outside_peek():
    """Every quality byte one of four values, but the last 40 records'
    Phred 8, which the 64 KiB head never shows."""
    arr = np.frombuffer(_uniform(4000, 100), np.uint8)
    nl = np.flatnonzero(arr == 10)
    rs, o3 = int(nl[3]) + 1, int(nl[2])
    arr = arr.reshape(-1, rs).copy()
    q = arr[:, o3 + 1:rs - 1].astype(np.int32) - 33
    lut, edges = np.array([2, 12, 23, 37]), np.array([7, 18, 30])
    arr[:, o3 + 1:rs - 1] = lut[np.searchsorted(edges, q)] + 33
    arr[-40:, o3 + 1:rs - 1] = 33 + 8
    return arr.tobytes()


def _write(tmp_path, raw):
    p = tmp_path / "reads.fastq"
    p.write_bytes(raw)
    return str(p)


def _same_report(a, b):
    assert a.to_dict() == b.to_dict()
    for k in ("qual_hist", "per_pos_base_counts", "length_hist"):
        assert np.array_equal(getattr(a, k), getattr(b, k)), k


def test_off_span_is_the_shared_no_op(fresh):
    assert not tracing._capturing
    a, b = tracing.span("bs.qc.route"), tracing.span("bs.feed.fill")
    assert a is b
    with a as got:
        assert got is None
        tracing.count("qc.reruns")
    assert fresh.spans == [] and fresh.requests() == []
    assert not fresh.times and not fresh.counters
    with tracing.capture():
        assert tracing.span("bs.qc.route") is not a
    assert tracing.span("bs.qc.route") is a


@pytest.mark.parametrize("entry", ["run_file_device", "run_file"])
def test_spans_nest_in_the_profilers_trace(tmp_path, fresh, entry):
    p = _write(tmp_path, _uniform(3000, 80))
    model = QCModel(quality_schema="sanger", max_read_len=128, device="cpu",
                    batch_size=1024)
    with tracing.device_trace(str(tmp_path / "trace")):
        if entry == "run_file":
            model.run_file(p)
        else:
            model.run_file_device(p, chunk_mb=1)
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    # the profiler's record-function ranges (cpu_op events from its C++
    # form, user_annotation from the Python one)
    ranges = [e for e in events if e.get("ph") == "X"
              and e.get("cat") in ("cpu_op", "user_annotation")
              and e.get("name", "").startswith("bs.")]
    (req,) = [e for e in ranges if e["name"] == "bs." + entry]
    names = {e["name"] for e in ranges}
    if entry == "run_file":
        assert {"bs.parse.batch", "bs.parse.alloc", "bs.qc.upload",
                "bs.qc.step", "bs.qc.report"} <= names
    else:
        assert FEED_SPANS <= names

    def inside(e, outer):
        return (e["tid"] == outer["tid"] and outer["ts"] <= e["ts"]
                and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"])

    assert all(inside(e, req) for e in ranges)
    batches = [e for e in ranges if e["name"] == "bs.parse.batch"]
    for e in ranges:
        if e["name"] == "bs.parse.alloc":
            assert any(inside(e, b) for b in batches)
    assert len(fresh.requests()) == 1


def test_parents_requests_and_self_time(fresh):
    t = tracing.Tracer()
    for _ in range(2):
        with t.section("bs.run_file"):
            t.count("parse.batches")
            with t.section("outer"):
                with t.section("inner"):
                    time.sleep(0.002)
                    t.count("parse.reads", 7)
                time.sleep(0.001)
            with t.section("outer"):
                pass
    by_id = {s.id: s for s in t.spans}
    reqs = t.requests()
    assert [r["name"] for r in reqs] == ["bs.run_file"] * 2
    for r in reqs:
        mine = [s for s in t.spans if s.request == r["id"]]
        assert len(mine) == 4
        (top,) = [s for s in mine if s.parent is None]
        assert top.id == r["id"] and top.name == "bs.run_file"
        inner = next(s for s in mine if s.name == "inner")
        outers = [s for s in mine if s.name == "outer"]
        assert by_id[inner.parent].name == "outer"
        assert all(s.parent == top.id for s in outers)
        ns = {s.name: 0 for s in mine}
        for s in mine:
            ns[s.name] += s.end_ns - s.start_ns
        sp = r["spans"]
        for name, v in sp.items():
            assert v["total_s"] == pytest.approx(ns[name] * 1e-9, abs=1e-12)
        # a span's self time leaves out its children and their own
        # bookkeeping; the request splits exactly into self times and that
        # bookkeeping
        assert sp["inner"]["self_s"] == sp["inner"]["total_s"]
        assert sp["outer"]["self_s"] < (ns["outer"] - ns["inner"]) * 1e-9
        assert sp["bs.run_file"]["self_s"] < (ns["bs.run_file"]
                                              - ns["outer"]) * 1e-9
        assert r["overhead_s"] > 0
        assert sum(v["self_s"] for v in sp.values()) + r["overhead_s"] == \
            pytest.approx(sp["bs.run_file"]["total_s"], abs=1e-9)
        assert r["spans"]["outer"]["calls"] == 2
        assert r["spans"]["inner"]["self_s"] >= 0.002
        assert r["counters"] == {"parse.batches": 1, "parse.reads": 7}
    assert reqs[0]["id"] != reqs[1]["id"]
    assert t.counters == {"parse.batches": 2, "parse.reads": 14}
    assert t.calls == {"bs.run_file": 2, "outer": 4, "inner": 2}
    assert t.requests(last=1) == reqs[1:]
    lines = t.report().splitlines()
    assert lines[1].split()[0] == "bs.run_file"


def test_a_request_opens_inside_a_plain_span(fresh):
    with tracing.capture():
        assert tracing.request_count("parse.reads") == 0
        with tracing.span("job"):
            tracing.count("parse.reads", 3)
            assert tracing.request_count("parse.reads") == 0
            with tracing.span("bs.run_file"):
                tracing.count("parse.reads", 5)
                with tracing.span("bs.run_file_device"):
                    tracing.count("parse.reads", 2)
                    assert tracing.request_count("parse.reads") == 7
    assert tracing.request_count("parse.reads") == 0
    job, req, inner = sorted(fresh.spans, key=lambda s: s.id)
    assert job.request is None and req.parent == job.id
    assert req.request == req.id and inner.request == req.id
    (r,) = fresh.requests()
    assert r["name"] == "bs.run_file" and r["counters"] == {"parse.reads": 7}
    assert fresh.counters == {"parse.reads": 10}


def test_a_second_threads_spans_do_not_nest(fresh):
    t = tracing.Tracer()
    opened = threading.Event()
    done = threading.Event()

    def other():
        opened.wait(10)
        with t.section("bs.other"):
            t.count("other")
            time.sleep(0.003)
        done.set()

    th = threading.Thread(target=other)
    th.start()
    with t.section("bs.run_file_device"):
        opened.set()
        assert done.wait(10)
    th.join(10)
    assert not th.is_alive()
    (o,) = [s for s in t.spans if s.name == "bs.other"]
    assert o.parent is None and o.request is None
    (r,) = t.requests()
    assert set(r["spans"]) == {"bs.run_file_device"}
    assert r["counters"] == {}
    assert r["spans"]["bs.run_file_device"]["self_s"] == \
        r["spans"]["bs.run_file_device"]["total_s"]


def test_the_bound_drops_spans_and_counts_them(fresh, monkeypatch):
    monkeypatch.setattr(tracing, "MAX_SPANS", 3)
    t = tracing.Tracer()
    with t.section("bs.run_file"):
        for _ in range(4):
            with t.section("bs.parse.batch"):
                pass
    assert len(t.spans) == 3
    assert t.counters[tracing.DROPPED] == 2
    assert t.calls == {"bs.run_file": 1, "bs.parse.batch": 4}
    (r,) = t.requests()
    assert r["spans"]["bs.parse.batch"]["calls"] == 4
    assert r["spans"]["bs.run_file"]["calls"] == 1


def _short_tail(full_chunks, chunk_bytes):
    """Uniform 176-byte records: `full_chunks` whole chunks of
    `chunk_bytes`, a chunk of four whole records, then the last record
    without its final newline (the host route's)."""
    block = np.frombuffer(_uniform(20_000, 80), np.uint8)  # 5-digit ids
    n = full_chunks * (chunk_bytes // 176) + 5
    return np.resize(block, n * 176).tobytes()[:-1]


@pytest.mark.parametrize("case", ["uniform", "short_tail", "failed_proof",
                                  "rerun"])
def test_run_file_device_spans_and_counters(tmp_path, fresh, case):
    raw = {"uniform": lambda: _uniform(8000, 80),
           "short_tail": lambda: _short_tail(3, 1 << 20),
           "failed_proof": lambda: _uniform(10_000, 60) + _var_ids(3000, 60,
                                                                   4),
           "rerun": _outside_peek}[case]()
    p = _write(tmp_path, raw)
    model = QCModel(quality_schema="sanger", max_read_len=128, device="cpu")
    off = model.run_file_device(p, chunk_mb=1)
    assert fresh.requests() == [] and not fresh.counters
    with tracing.capture() as t:
        on = model.run_file_device(p, chunk_mb=1)
    _same_report(on, off)
    (r,) = t.requests()
    assert r["name"] == "bs.run_file_device"
    spans, c = r["spans"], r["counters"]
    assert FEED_SPANS <= set(spans)
    assert spans["bs.run_file_device"]["calls"] == 1
    assert all(s.request == r["id"] for s in t.spans)
    fed, thrown = c["qc.dispatched_bytes"], c.get("qc.discarded_bytes", 0)
    assert c["feed.chunks"] == spans["bs.feed.dispatch"]["calls"]
    assert c["feed.staged_bytes"] >= fed > 0
    if case in ("uniform", "short_tail"):
        assert thrown == 0 and "qc.failed_proofs" not in c
        assert "qc.reruns" not in c
        assert c["feed.chunks"] == model.tier_chunks["uniform"] > 1
        # every chunk, the short last one too, is fed as the mapping's
        # bytes: nothing filled, nothing staged past the records
        assert "bs.feed.fill" not in spans
        assert c["feed.staged_bytes"] == fed
        # the CPU path stages nothing, so no copy is split
        assert "feed.split_chunks" not in c
        if case == "short_tail":
            assert model.tier_chunks["uniform"] == 4
            assert model.tier_chunks["host"] == 1
            _same_report(on, QCModel(quality_schema="sanger",
                                     max_read_len=128,
                                     device="cpu").run_file(p))
    elif case == "failed_proof":
        assert c["qc.failed_proofs"] >= 1 and 0 < thrown < fed
        assert "bs.feed.fill" in spans  # the semi tier's normalizer
        assert model.tier_chunks["semi"] > 0
    else:
        assert c["qc.reruns"] == 1 and "qc.failed_proofs" not in c
        # the first pass fed what the second fed, and was thrown away
        assert 2 * thrown == fed
        assert on.qual_hist[8] == 40 * 100


def test_run_file_device_short_tail_on_card(tmp_path, fresh):
    """The short last uniform chunk at 256 MiB chunks on the card: the
    report equals the host route's, the feed stages exactly the records it
    dispatches, and every full chunk's staging copy is split."""
    import torch

    from blazeseq_tpu_torch.parallel import ingest

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: pinned staging and kernel B")
    p = _write(tmp_path, _short_tail(2, 256 << 20))
    model = QCModel(quality_schema="sanger", max_read_len=128)
    off = model.run_file_device(p, chunk_mb=256)
    with tracing.capture() as t:
        on = model.run_file_device(p, chunk_mb=256)
    _same_report(on, off)
    _same_report(on, QCModel(quality_schema="sanger",
                             max_read_len=128).run_file(p))
    assert (model.tier_chunks["uniform"], model.tier_chunks["host"]) == (3, 1)
    (r,) = t.requests()
    c = r["counters"]
    assert "bs.feed.fill" not in r["spans"]
    assert c["feed.staged_bytes"] == c["qc.dispatched_bytes"]
    split = 2 if ingest._stage_threads() > 1 else 0
    assert c.get("feed.split_chunks", 0) == split


def test_run_file_spans_once_a_batch(tmp_path, fresh):
    p = _write(tmp_path, _uniform(2500, 80))
    model = QCModel(quality_schema="sanger", max_read_len=128, device="cpu",
                    batch_size=512, adapters=[b"AGATCGGAAGAG", b"TGGAATTC"],
                    track_duplicates=True, dup_track_limit=10_000,
                    track_quartiles=True)
    off = model.run_file(p)
    with tracing.capture() as t:
        on = model.run_file(p)
    _same_report(on, off)
    assert on.to_dict()["adapters"] == off.to_dict()["adapters"]
    (r,) = t.requests()
    assert r["name"] == "bs.run_file"
    batches = -(-2500 // 512)
    assert r["counters"] == {"parse.batches": batches, "parse.reads": 2500}
    for name in ("bs.parse.batch", "bs.parse.alloc", "bs.qc.upload",
                 "bs.qc.step", "bs.qc.adapters", "bs.qc.hashes"):
        assert r["spans"][name]["calls"] == batches, name
    assert r["spans"]["bs.qc.report"]["calls"] == 2
    alloc = next(s for s in t.spans if s.name == "bs.parse.alloc")
    parent = next(s for s in t.spans if s.id == alloc.parent)
    assert parent.name == "bs.parse.batch"
