"""Parity: the port's FastqBatch.to_padded (blazeseq_tpu_torch/fastq/batch.py,
one memcpy a row in native/scan.cpp::bs_pad_rows) and its numpy fallback
(native._pad_rows_np, called directly) against the reference's
FastqBatch.to_padded (blazeseq_tpu/fastq/batch.py).

Cases: max_len below, at and above the longest read (rows clamped, lengths
true), pad_records_to, an empty batch, zero-length reads, one read of
10,000 bp and a batch of 4,096 reads. Every leaf with np.array_equal.
"""

import numpy as np
import pytest

from blazeseq_tpu.fastq.batch import FastqBatch as RefBatch
from blazeseq_tpu_torch import native
from blazeseq_tpu_torch.fastq.batch import FastqBatch


def _arrays(lens, seed):
    """seq, qual, ends, id bytes and id ends of records of these lengths,
    every byte value drawn."""
    rng = np.random.default_rng(seed)
    lens = np.asarray(lens, np.int64)
    ends = np.cumsum(lens).astype(np.int64)
    total = int(ends[-1]) if len(ends) else 0
    seq = rng.integers(0, 256, total).astype(np.uint8)
    qual = rng.integers(0, 256, total).astype(np.uint8)
    return seq, qual, ends, np.zeros(0, np.uint8), np.zeros(len(lens),
                                                            np.int64)


def _longest(lens):
    return int(max(lens)) if len(lens) else 0


# (label, read lengths, to_padded keywords as a function of the longest)
CASES = [
    ("max_len below the longest", [150, 300, 7, 129, 128], lambda m: dict(
        max_len=100)),
    ("max_len at the longest", [150, 300, 7, 129, 128], lambda m: dict(
        max_len=m)),
    ("max_len above the longest", [150, 300, 7, 129, 128], lambda m: dict(
        max_len=m + 200)),
    ("no max_len", [150, 300, 7, 129, 128], lambda m: {}),
    ("max_len 0", [150, 3], lambda m: dict(max_len=0)),
    ("pad_records_to", [150, 40, 0, 151], lambda m: dict(pad_records_to=9)),
    ("pad_records_to below n", [150, 40, 0, 151], lambda m: dict(
        pad_records_to=2, max_len=64)),
    ("empty batch", [], lambda m: {}),
    ("empty batch, padded", [], lambda m: dict(max_len=150,
                                               pad_records_to=4)),
    ("zero-length reads", [0, 0, 5, 0, 17, 0], lambda m: {}),
    ("all reads empty", [0, 0, 0], lambda m: dict(max_len=10)),
    ("one read of 10,000 bp", [10_000], lambda m: {}),
    ("one read of 10,000 bp, clamped", [10_000], lambda m: dict(
        max_len=256)),
    ("4,096 reads", list(np.random.default_rng(7).integers(0, 301, 4096)),
     lambda m: dict(max_len=300)),
    ("4,096 reads of 150 bp", [150] * 4096, lambda m: dict(max_len=150)),
]


def _check(got, want):
    for leaf in ("seq", "qual", "lengths"):
        g, w = getattr(got, leaf), getattr(want, leaf)
        assert g.dtype == w.dtype and g.shape == w.shape, leaf
        assert np.array_equal(g, w), leaf
    assert got.n_records == want.n_records
    assert got.quality_offset == want.quality_offset


@pytest.mark.parametrize("label,lens,kw", CASES, ids=[c[0] for c in CASES])
def test_to_padded_matches_reference(label, lens, kw):
    arrays = _arrays(lens, len(label))
    kwargs = kw(_longest(lens))
    want = RefBatch.from_arrays(*arrays, quality_offset=64).to_padded(
        **kwargs)
    got = FastqBatch.from_arrays(*arrays, quality_offset=64).to_padded(
        **kwargs)
    _check(got, want)


@pytest.mark.parametrize("label,lens,kw", CASES, ids=[c[0] for c in CASES])
def test_numpy_fallback_matches_reference(label, lens, kw):
    seq, qual, ends, *ids = _arrays(lens, len(label))
    want = RefBatch.from_arrays(seq, qual, ends, *ids).to_padded(
        **kw(_longest(lens)))
    rows, width = want.seq.shape
    got = native._pad_rows_np(seq, qual, ends, width, rows)
    for g, w in zip(got, (want.seq, want.qual, want.lengths)):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_native_row_copy_is_built():
    """The C++ row copy is what to_padded runs where g++ is present."""
    if not native.has_native():
        pytest.skip("no C++ compiler: the numpy fallback runs")
    assert hasattr(native._load(), "bs_pad_rows")
    seq, qual, ends, *_ = _arrays([3, 0, 200], 1)
    s, q, n = native.pad_rows(seq, qual, ends, 128, 5)
    assert n.tolist() == [3, 0, 200, 0, 0]
    assert s[2].tobytes() == seq[3:131].tobytes()
    assert not s[3:].any() and not q[3:].any() and not s[0, 3:].any()


def test_records_added_one_by_one_pad_as_the_reference():
    """A batch built from records (the staging path, finalised on the
    first to_padded) pads the same."""
    from blazeseq_tpu.fastq.record import FastqRecord as RefRecord
    from blazeseq_tpu_torch.fastq.record import FastqRecord

    rng = np.random.default_rng(3)
    recs = [(b"r%d" % i, bytes(rng.choice(list(b"ACGTN"), k).tolist()),
             bytes(rng.integers(33, 75, k).tolist()))
            for i, k in enumerate([0, 12, 300, 129])]
    got = FastqBatch.from_records([FastqRecord(*r) for r in recs])
    want = RefBatch.from_records([RefRecord(*r) for r in recs])
    _check(got.to_padded(max_len=200), want.to_padded(max_len=200))


@pytest.mark.parametrize("ends,seq_len", [([5, 3], 8), ([-1], 4),
                                          ([4, 9], 8)])
def test_pad_rows_refuses_bad_ends(ends, seq_len):
    seq = np.zeros(seq_len, np.uint8)
    with pytest.raises(ValueError, match="record ends"):
        native.pad_rows(seq, seq, np.array(ends, np.int64), 128, len(ends))
