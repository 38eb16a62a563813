"""Parity: the PyTorch port's ops/stats.py against blazeseq_tpu/ops/stats.py.

Both packages get the same padded batches (FastqParser.padded_batches over
corpora made from a numpy seed); every integer leaf must be equal
(np.array_equal), and the accumulator's float metrics agree to rel 1e-12.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import blazeseq_tpu as bt
from blazeseq_tpu.fastq.parser import FastqParser, ParserConfig
from blazeseq_tpu.io.readers import MemoryReader
from blazeseq_tpu.ops import stats as jstats
from blazeseq_tpu_torch.ops import stats as tstats

OFFSET = 33


def _batch(n_reads, min_len, max_len, width, pad_to=None, low_qual=False,
           seed=0):
    buf = bytearray(bt.generate_synthetic_fastq_buffer(
        n_reads, min_len, max_len, 2, 40, "sanger"))
    if low_qual:
        # quality bytes below the offset: clamped to Phred 0 by the stats
        rng = np.random.default_rng(seed)
        lines = bytes(buf).split(b"\n")
        pos = 0
        for i, ln in enumerate(lines):
            if i % 4 == 3 and ln and rng.random() < 0.5:
                buf[pos + int(rng.integers(0, len(ln)))] = 0x21 - 5
            pos += len(ln) + 1
    parser = FastqParser(MemoryReader(bytes(buf)), config=ParserConfig())
    return next(parser.padded_batches(n_reads, max_len=width,
                                      pad_records_to=pad_to))


def _both(pb):
    j = (jnp.asarray(pb.seq), jnp.asarray(pb.qual),
         jnp.asarray(pb.lengths, dtype=jnp.int32))
    t = (torch.from_numpy(np.array(pb.seq)),
         torch.from_numpy(np.array(pb.qual)),
         torch.from_numpy(np.asarray(pb.lengths, np.int32)))
    return j, t


def _assert_leaves_equal(jst, tst):
    got = tst.to_numpy()
    for name, a, b in zip(jst._fields, jst, got):
        if a is None:
            assert b is None, name
            continue
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=name)


CASES = {
    # name: (batch kwargs, qc_stats kwargs)
    "plain": (dict(n_reads=200, min_len=40, max_len=120, width=128), {}),
    "padded_rows": (dict(n_reads=150, min_len=30, max_len=100, width=128,
                         pad_to=256), {}),
    "long_reads": (dict(n_reads=120, min_len=90, max_len=200, width=128), {}),
    "low_qual": (dict(n_reads=160, min_len=50, max_len=110, width=128,
                      low_qual=True), {}),
    "col_offset": (dict(n_reads=100, min_len=100, max_len=250, width=128),
                   dict(col_offset=96)),
    "qual_hist_2d": (dict(n_reads=90, min_len=20, max_len=120, width=128,
                          low_qual=True), dict(qual_hist_2d=True)),
    "no_scalars": (dict(n_reads=80, min_len=40, max_len=90, width=128),
                   dict(count_scalars=False)),
    "no_row_stats": (dict(n_reads=80, min_len=40, max_len=90, width=128),
                     dict(row_stats=False, col_offset=32)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_qc_stats_parity(case):
    bkw, skw = CASES[case]
    pb = _batch(**bkw)
    (js, jq, jl), (ts, tq, tl) = _both(pb)
    n = pb.seq.shape[0]
    rng = np.random.default_rng(1)
    codes = rng.choice([0, 0, 0, 4, 5], n).astype(np.int32)
    nr = pb.n_records
    jst = jstats.qc_stats(js, jq, jl, jnp.int32(OFFSET),
                          n_records=jnp.int32(nr),
                          error_codes=jnp.asarray(codes), **skw)
    tst = tstats.qc_stats(ts, tq, tl, OFFSET, n_records=nr,
                          error_codes=torch.from_numpy(codes), **skw)
    _assert_leaves_equal(jst, tst)
    if case == "padded_rows":
        assert nr < n


@pytest.mark.parametrize("case", ["plain", "padded_rows", "col_offset",
                                  "low_qual"])
def test_row_partials_and_histograms(case):
    bkw, skw = CASES[case]
    col = skw.get("col_offset", 0)
    pb = _batch(**bkw)
    (js, jq, jl), (ts, tq, tl) = _both(pb)
    nr = pb.n_records
    jp = jstats.row_partials(js, jq, jl, jnp.int32(OFFSET),
                             n_records=jnp.int32(nr), col_offset=col)
    tp = tstats.row_partials(ts, tq, tl, OFFSET, n_records=nr,
                             col_offset=col)
    for a, b in zip(jp, tp):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    jh = jstats.row_histograms(*jp, jl, jnp.int32(nr))
    th = tstats.row_histograms(*tp, tl, nr)
    for a, b in zip(jh, th):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("qual_hist_2d", [False, True])
def test_zero_stats_parity(qual_hist_2d):
    jz = jstats.zero_stats(192, qual_hist_2d)
    tz = tstats.zero_stats(192, qual_hist_2d)
    _assert_leaves_equal(jz, tz)
    assert all(a is None or a.dtype == torch.int32 for a in tz)


def test_accumulator_widening_parity():
    # batches of different padded widths: the position leaves widen
    batches = [_batch(150, 30, 100, 128, seed=1),
               _batch(120, 100, 240, 256, seed=2),
               _batch(60, 20, 60, 128, low_qual=True, seed=3)]
    ja, ta = jstats.QCAccumulator(), tstats.QCAccumulator()
    for pb in batches:
        (js, jq, jl), (ts, tq, tl) = _both(pb)
        ja.add(jstats.qc_stats(js, jq, jl, jnp.int32(OFFSET),
                               n_records=jnp.int32(pb.n_records)))
        ta.add(tstats.qc_stats(ts, tq, tl, OFFSET, n_records=pb.n_records))
    for name, a, b in zip(ja.total._fields, ja.total, ta.total):
        if a is None:
            assert b is None
            continue
        assert b.dtype == np.int64, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert ta.total.per_pos_count.shape == (256,)
    for metric in ("gc_fraction", "mean_quality"):
        assert getattr(ta, metric)() == pytest.approx(
            getattr(ja, metric)(), rel=1e-12), metric
    np.testing.assert_allclose(ta.per_position_mean_quality(),
                               ja.per_position_mean_quality(), rtol=1e-12)


def test_qcstats_numpy_round_trip():
    pb = _batch(100, 40, 120, 128)
    (js, jq, jl), _ = _both(pb)
    jst = jstats.qc_stats(js, jq, jl, jnp.int32(OFFSET),
                          n_records=jnp.int32(pb.n_records))
    tst = tstats.qcstats_from_numpy([None if a is None else np.asarray(a)
                                     for a in jst])
    _assert_leaves_equal(jst, tst)
