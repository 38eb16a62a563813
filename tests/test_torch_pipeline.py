"""Parity: the PyTorch port's padded-batch step
(blazeseq_tpu_torch/parallel/pipeline.py) against the no-mesh
build_qc_align_step of blazeseq_tpu/parallel/pipeline.py, without and with
alignment.

Both get the same padded batch (FastqParser.padded_batches over a seeded
corpus with padding rows, reads longer than the width, out-of-range quality
bytes and high-bit bytes; and the flagship entry's example batch). Error
codes, phred, the alignment scores and every QCStats leaf must be equal
(np.array_equal); without alignment the scores are zeros on both sides.
"""

import numpy as np
import pytest
import torch

import blazeseq_tpu as bt
from blazeseq_tpu.fastq.parser import FastqParser, ParserConfig
from blazeseq_tpu.fastq.quality import parse_schema
from blazeseq_tpu.io.readers import MemoryReader
from blazeseq_tpu_torch.parallel.pipeline import (build_qc_align_step,
                                                  run_qc_align)

SANGER = parse_schema("sanger")


def _batch(seed):
    buf = bytearray(bt.generate_synthetic_fastq_buffer(
        300, 40, 180, 2, 40, "sanger"))
    rng = np.random.default_rng(seed)
    lines = bytes(buf).split(b"\n")
    pos = 0
    for i, ln in enumerate(lines):
        if ln and i % 4 in (1, 3) and rng.random() < 0.05:
            # a high-bit byte in seq or qual, or a quality byte out of range
            j = pos + int(rng.integers(0, len(ln)))
            buf[j] = (buf[j] | 0x80) if rng.random() < 0.5 else 0x20
        pos += len(ln) + 1
    parser = FastqParser(MemoryReader(bytes(buf)), config=ParserConfig())
    return next(parser.padded_batches(512, max_len=128, pad_records_to=512))


@pytest.mark.parametrize("check_ascii,check_quality",
                         [(True, True), (True, False), (False, True)])
def test_step_matches_reference(check_ascii, check_quality):
    jnp = pytest.importorskip("jax.numpy")
    ref = pytest.importorskip("blazeseq_tpu.parallel.pipeline")
    pb = _batch(seed=11)
    assert pb.n_records < pb.seq.shape[0]
    lengths = np.asarray(pb.lengths, np.int32)
    assert (lengths > pb.seq.shape[1]).any()
    jfn = ref.build_qc_align_step(None, check_ascii=check_ascii,
                                  check_quality=check_quality,
                                  with_alignment=False)
    want = jfn(jnp.asarray(pb.seq), jnp.asarray(pb.qual),
               jnp.asarray(lengths), jnp.int32(pb.n_records),
               jnp.zeros(8, jnp.uint8), jnp.int32(SANGER.LOWER),
               jnp.int32(SANGER.UPPER), jnp.int32(SANGER.OFFSET))
    fn = build_qc_align_step(check_ascii=check_ascii,
                             check_quality=check_quality)
    got = fn(torch.from_numpy(np.array(pb.seq)),
             torch.from_numpy(np.array(pb.qual)), torch.from_numpy(lengths),
             int(pb.n_records), SANGER)
    np.testing.assert_array_equal(np.asarray(want.error_codes),
                                  got.error_codes.numpy())
    np.testing.assert_array_equal(np.asarray(want.phred), got.phred.numpy())
    np.testing.assert_array_equal(np.asarray(want.nw_scores),
                                  got.nw_scores.numpy())
    for name, a, b in zip(want.stats._fields, want.stats,
                          got.stats.to_numpy()):
        if a is None:
            assert b is None, name
            continue
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=name)
    assert int(got.stats.error_reads) > 0


def _assert_results_equal(want, got):
    np.testing.assert_array_equal(np.asarray(want.error_codes),
                                  got.error_codes.numpy())
    np.testing.assert_array_equal(np.asarray(want.phred), got.phred.numpy())
    np.testing.assert_array_equal(np.asarray(want.nw_scores),
                                  got.nw_scores.numpy())
    assert got.nw_scores.dtype == torch.int32
    for name, a, b in zip(want.stats._fields, want.stats,
                          got.stats.to_numpy()):
        if a is None:
            assert b is None, name
            continue
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=name)


def _run_both(pb, ref, **kw):
    """The reference's and the port's step with alignment on one batch."""
    jnp = pytest.importorskip("jax.numpy")
    ref_pipe = pytest.importorskip("blazeseq_tpu.parallel.pipeline")
    lengths = np.asarray(pb.lengths, np.int32)
    jfn = ref_pipe.build_qc_align_step(None, with_alignment=True, **kw)
    want = jfn(jnp.asarray(pb.seq), jnp.asarray(pb.qual),
               jnp.asarray(lengths), jnp.int32(pb.n_records),
               jnp.asarray(ref), jnp.int32(SANGER.LOWER),
               jnp.int32(SANGER.UPPER), jnp.int32(SANGER.OFFSET))
    fn = build_qc_align_step(with_alignment=True, **kw)
    got = fn(torch.from_numpy(np.array(pb.seq)),
             torch.from_numpy(np.array(pb.qual)), torch.from_numpy(lengths),
             int(pb.n_records), SANGER, torch.from_numpy(np.array(ref)))
    return want, got


@pytest.mark.parametrize("qual_hist_2d", [False, True])
def test_align_step_matches_reference_on_example_batch(qual_hist_2d):
    """The flagship entry's batch: 64 records, width 128, reference 64."""
    graft = pytest.importorskip("__graft_entry__")
    pb, ref = graft._example_batch()
    assert pb.seq.shape == (64, 128) and ref.shape == (64,)
    want, got = _run_both(pb, ref, qual_hist_2d=qual_hist_2d)
    _assert_results_equal(want, got)
    assert (got.nw_scores.numpy() != 0).any()
    assert (got.stats.per_pos_qual_hist is not None) == qual_hist_2d


def test_align_step_matches_reference_with_faults():
    """Padding rows, reads longer than the width (aligned on their clamped
    prefix) and records that fail validation are all aligned."""
    pb = _batch(seed=12)
    ref = np.frombuffer(b"GATTACA" * 9, np.uint8)
    want, got = _run_both(pb, ref)
    _assert_results_equal(want, got)
    assert int(got.stats.error_reads) > 0
    assert (np.asarray(pb.lengths) > pb.seq.shape[1]).any()


def test_align_step_needs_a_reference():
    pb = _batch(seed=13)
    fn = build_qc_align_step(with_alignment=True)
    with pytest.raises(ValueError, match="reference"):
        fn(torch.from_numpy(np.array(pb.seq)),
           torch.from_numpy(np.array(pb.qual)),
           torch.from_numpy(np.asarray(pb.lengths, np.int32)),
           int(pb.n_records), SANGER)


@pytest.mark.parametrize("kw,match", [
    (dict(mesh=object()), "multi-GPU"),
])
def test_unported_step_options_raise(kw, match):
    with pytest.raises(NotImplementedError, match=match):
        build_qc_align_step(**kw)


@pytest.mark.parametrize("kw", [{}, dict(with_alignment=False),
                                dict(check_quality=False, qual_hist_2d=True)])
def test_run_qc_align_matches_reference(kw):
    """The wrapper on one padded batch and a reference read given as bytes,
    against the reference's run_qc_align (alignment on unless turned off)."""
    ref_pipe = pytest.importorskip("blazeseq_tpu.parallel.pipeline")
    pb = _batch(seed=14)
    read = b"GATTACA" * 9
    want = ref_pipe.run_qc_align(pb, read, SANGER, **kw)
    got = run_qc_align(pb, read, SANGER, device="cpu", **kw)
    _assert_results_equal(want, got)
    assert (got.nw_scores.numpy() != 0).any() == kw.get("with_alignment",
                                                        True)


def test_run_qc_align_refusals():
    pb = _batch(seed=15)
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        run_qc_align(pb, b"ACGT", SANGER, mesh=object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run_qc_align(pb, b"ACGT", SANGER)
