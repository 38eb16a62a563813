"""The plain references against what the generators planted, and the
controls (control.py) coming out not correct.

    python -m pytest bench_port -q
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from bench_port import control, harness  # noqa: E402
from bench_port.reference import _fastq as fq  # noqa: E402
from bench_port.reference import cli, panels_qc  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture
def make(request):
    """make(config, seed, reads) -> (config dict, corpus), closed after
    the test."""
    def _make(config, seed, reads):
        cfg = harness.load_json("configs", config + ".json")
        c = harness.load_module("gen", config).generate(cfg, seed, CPU,
                                                        reads=reads)
        request.addfinalizer(c.file.close)
        return cfg, c

    return _make


def test_throughput_generator_is_upstreams_at_seed_0(make):
    from blazeseq_tpu_torch.utils import generate_synthetic_fastq_buffer

    cfg, c = make("blazeseq_throughput_100bp", 0, 3000)
    want = generate_synthetic_fastq_buffer(3000, 100, 100, 2, 40, "sanger")
    assert c.file.read().tobytes() == bytes(want)


def test_throughput_reference_counts(make):
    cfg, c = make("blazeseq_throughput_100bp", 77, 4000)
    params = harness.load_json("traffic", "device_qc.json")["params"]
    want = harness.load_module("reference", "device_qc").expected(
        c, cfg, params, CPU)
    assert want["reads"] == c.planted["reads"] == 4000
    assert want["bases"] == c.planted["bases"] == 400000
    assert want["error_reads"] == 0
    assert want["length_hist"][100] == 4000
    ph = np.flatnonzero(want["qual_hist"])
    assert ph.min() >= cfg["min_phred"] and ph.max() <= cfg["max_phred"]
    assert abs(want["gc_fraction"] - cfg["gc_bias"]) < 0.01


def test_novaseq_reference_counts(make):
    cfg, c = make("novaseq6000_150bp_binned", 78, 6000)
    params = harness.load_json("traffic", "panels_fastqc.json")["params"]
    want = panels_qc.expected(c, cfg, params, CPU)
    p = c.planted
    assert want["reads"] == p["reads"] and want["bases"] == p["bases"]
    assert want["base_counts"][4] == p["n_calls"]  # N only from calls
    assert set(np.flatnonzero(want["qual_hist"])) <= set(cfg["quality_bins"])
    universal = want["adapters"][b"AGATCGGAAGAG"]
    # the read-through adapter where it fits, chance hits aside (N calls
    # can hide a few)
    assert abs(int(universal[1]) - p["adapter_in_read"]) <= 0.01 * p["reads"]
    assert abs(want["gc_fraction"] - cfg["gc"]) < 0.05
    # the copies make the sample less unique than the planted share
    assert want["frac_unique_reads"] < 1 - 0.5 * cfg["duplicate_fraction"]
    # the adapter dimers are the overrepresented sequence
    assert want["overrepresented"][0][0].startswith(b"AGATCGGAAGAGCACACG")
    assert want["overrepresented"][0][1] >= 0.5 * p["dimers"]


def test_trim_reference_cuts_the_failing_ends(make):
    cfg, c = make("novaseq6000_150bp_binned", 79, 5000)
    params = harness.load_json("traffic", "cli_trim_window.json")["params"]
    data = fq.to_device(c.file.array(), CPU)
    recs = fq.records(data)
    keep = cli.cuts(data, recs, params["window"], params["mean_q"],
                    cfg["quality_offset"])
    cut = int((keep < recs.seq_len).sum())
    assert cut >= 0.9 * c.planted["q2_tails"]
    want = cli.expected(c, cfg, params, CPU)
    assert want["counts"][:2] == (5000, int((keep > 0).sum()))
    assert cli.records_differing(want["bytes"], want["bytes"]) == 0


@pytest.mark.parametrize("cell", ["device_qc.throughput_100bp",
                                  "device_qc.novaseq_150bp",
                                  "panels_qc.novaseq_150bp",
                                  "cli_trim.novaseq_150bp"])
def test_control_is_not_correct(cell):
    r = control.readings(cell, 80, CPU, reads=3000)
    assert all(v == 0 for v in r["program"].values())
    assert any(v > 0 for v in r["control"].values())


def test_float32_control_loses_counts_past_2_24(make):
    # at the cells' sizes a per-position Phred sum passes 2**24, where
    # float32 totals stop counting by ones
    cfg, c = make("blazeseq_throughput_100bp", 81, 1 << 19)
    data = fq.to_device(c.file.array(), CPU)
    c.file.release()
    recs = fq.records(data)
    kw = dict(width=256, offset=33, lower=33, upper=126, block=1 << 16)
    exact = fq.qc_totals(data, recs, **kw)
    low = fq.qc_totals(data, recs, dtype=torch.float32, **kw)
    assert exact.numpy("per_pos_qual_sum").max() > 1 << 24
    assert not np.array_equal(exact.numpy("per_pos_qual_sum"),
                              low.numpy("per_pos_qual_sum"))
