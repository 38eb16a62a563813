"""Parity: the PyTorch port's NWAligner(device="cpu")
(blazeseq_tpu_torch/models/aligner.py) against
blazeseq_tpu/models/aligner.py::NWAligner, for all six mode x gap
combinations, on batches with reads longer than max_query_len and rows
narrower than a read's true length. Scores are int32 and must be equal
(np.array_equal); verify_batch must hold. The card case holds
NWAligner(device="cuda") against the CPU one and skips where there is no
CUDA device.
"""

import numpy as np
import pytest
import torch

import blazeseq_tpu as bt
from blazeseq_tpu_torch import NWAligner
from blazeseq_tpu_torch.ops import nw

REF = b"GATTACAGGCTTAACGTAGGATCCAGTTACAGATTACAGGT"
MODES = [(mode, go) for mode in ("global", "local", "semiglobal")
         for go in (None, -3)]


def _batch(n=30, lo=20, hi=90):
    buf = bytes(bt.generate_synthetic_fastq_buffer(n, lo, hi, 2, 40,
                                                   "sanger"))
    return bt.FastqParser(bt.MemoryReader(buf)).next_batch(n)


def _jax_aligner(**kw):
    models = pytest.importorskip("blazeseq_tpu.models")
    return models.NWAligner(REF, **kw)


@pytest.mark.parametrize("mode,gap_open", MODES)
def test_aligner_matches_reference(mode, gap_open):
    batch = _batch()
    kw = dict(max_query_len=64, mode=mode, gap_open=gap_open)
    port = NWAligner(REF, device="cpu", **kw)
    ref = _jax_aligner(**kw)
    assert (batch.seq_lengths() > 64).any()  # the max_query_len clamp
    got = port.score_batch(batch)
    np.testing.assert_array_equal(ref.score_batch(batch), got)
    assert got.dtype == np.int32 and got.shape == (len(batch),)
    pb = batch.to_padded(max_len=128, pad_records_to=40)
    np.testing.assert_array_equal(ref.score_padded(pb), port.score_padded(pb))
    np.testing.assert_array_equal(port.score_cpu(batch), got)
    assert port.verify_batch(batch)


@pytest.mark.parametrize("mode,gap_open", [("global", None),
                                           ("local", -4)])
def test_rows_narrower_than_reads_score_their_prefix(mode, gap_open):
    """A 300 bp read in a 128-wide row (true length 300) scores its
    128-byte prefix, not the NEG sentinel."""
    rng = np.random.default_rng(7)
    long_seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), 300).tobytes()
    buf = (b"@r1\n" + long_seq + b"\n+\n" + b"I" * 300 + b"\n"
           b"@r2\nACGTTAGC\n+\nIIIIIIII\n")
    pb = bt.FastqParser(bt.MemoryReader(buf)).next_padded(4, max_len=128)
    assert np.asarray(pb.lengths)[:2].tolist() == [300, 8]
    kw = dict(max_query_len=256, mode=mode, gap_open=gap_open)
    port = NWAligner(REF, device="cpu", **kw)
    got = port.score_padded(pb)
    np.testing.assert_array_equal(_jax_aligner(**kw).score_padded(pb), got)
    twin = (nw.needleman_wunsch_cpu if gap_open is None else
            lambda q, r: nw.smith_waterman_affine_cpu(q, r, gap_open=-4))
    assert got[0] == twin(long_seq[:128], REF)
    assert got[0] > nw.NEG


def test_aligner_device_and_mode_rules():
    with pytest.raises(ValueError, match="mode"):
        NWAligner(b"ACGT", mode="overlap", device="cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        NWAligner(b"ACGT", device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            NWAligner(b"ACGT")
    # an empty reference is refused when scoring, as in the reference
    with pytest.raises(ValueError, match="non-empty"):
        NWAligner(b"", device="cpu").score_batch(_batch(4))


@pytest.mark.parametrize("mode,gap_open", MODES)
def test_aligner_on_card_matches_cpu(mode, gap_open):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    batch = _batch(n=200, lo=10, hi=300)
    kw = dict(max_query_len=256, mode=mode, gap_open=gap_open)
    before = nw.nw_scores.launches
    got = NWAligner(REF, device="cuda", **kw).score_batch(batch)
    np.testing.assert_array_equal(
        NWAligner(REF, device="cpu", **kw).score_batch(batch), got)
    # only global linear mode runs the kernel
    uses_kernel = mode == "global" and gap_open is None
    assert nw.nw_scores.launches == before + int(uses_kernel)
