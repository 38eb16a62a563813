"""The PyTorch port's device half of fastq/batch.py and its tracing module,
against the reference's FastqBatch.to_device / PaddedFastqBatch.to_device
and blazeseq_tpu/tracing.py.

An uploaded batch copied back to the host equals the original and the
reference's own round trip, array by array and record by record; a padded
batch on the device holds the same rows. device="cuda" refuses to run
without a card. device_trace writes a Chrome trace of the enclosed block.
"""

import json

import numpy as np
import pytest
import torch

import blazeseq_tpu as bt
from blazeseq_tpu_torch import tracing
from blazeseq_tpu_torch.fastq.batch import (DeviceFastqBatch,
                                            padded_to_device,
                                            upload_batch_to_device)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel worker processes: keep this module's
    torch CPU ops on one thread so they do not crowd the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(n=50, quality_offset=33):
    buf = bt.generate_synthetic_fastq_buffer(n, 0, 120, 2, 40, "sanger")
    b = bt.FastqParser(bt.MemoryReader(buf)).next_batch(n)
    b._quality_offset = quality_offset
    return b


def _host_arrays(b):
    b._finalize()
    return (b._sequence_bytes, b._quality_bytes, b._ends, b._id_bytes,
            b._id_ends)


@pytest.mark.parametrize("quality_offset", [33, 64])
def test_upload_round_trip_matches_reference(quality_offset):
    b = _batch(quality_offset=quality_offset)
    d = upload_batch_to_device(b, "cpu")
    assert isinstance(d, DeviceFastqBatch) and d.num_records() == 50
    assert d.seq.dtype == torch.uint8 and d.ends.dtype == torch.int64
    back = d.copy_to_host()
    for x, y in zip(_host_arrays(back), _host_arrays(b)):
        np.testing.assert_array_equal(x, y)
    assert back.quality_offset() == quality_offset
    assert [r.to_bytes() for r in d.to_records()] == [
        r.to_bytes() for r in b.to_records()]
    pytest.importorskip("jax")
    ref = b.to_device().copy_to_host()
    for x, y in zip(_host_arrays(back), _host_arrays(ref)):
        np.testing.assert_array_equal(x, y)


def test_upload_empty_batch():
    d = upload_batch_to_device(bt.FastqBatch(), "cpu")
    assert d.num_records() == 0 and d.copy_to_host().num_records() == 0


@pytest.mark.parametrize("max_len,pad_to", [(None, None), (64, 80)])
def test_padded_to_device_matches_reference(max_len, pad_to):
    pb = _batch().to_padded(max_len=max_len, pad_records_to=pad_to)
    d = padded_to_device(pb, "cpu")
    assert (d.n_records, d.quality_offset) == (pb.n_records,
                                               pb.quality_offset)
    assert d.lengths.dtype == torch.int32
    for name in ("seq", "qual", "lengths"):
        np.testing.assert_array_equal(getattr(d, name).numpy(),
                                      getattr(pb, name))
    pytest.importorskip("jax")
    ref = pb.to_device()
    for name in ("seq", "qual", "lengths"):
        np.testing.assert_array_equal(getattr(d, name).numpy(),
                                      np.asarray(getattr(ref, name)))


def test_cuda_upload_refused_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    b = _batch(5)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        upload_batch_to_device(b)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        padded_to_device(b.to_padded())


def test_upload_round_trip_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    b = _batch()
    d = upload_batch_to_device(b)
    assert d.seq.is_cuda and d.ends.is_cuda
    for x, y in zip(_host_arrays(d.copy_to_host()), _host_arrays(b)):
        np.testing.assert_array_equal(x, y)
    p = padded_to_device(b.to_padded())
    assert p.qual.is_cuda and p.lengths.dtype == torch.int32


def test_tracer_is_the_reference_host_tracer():
    """The port keeps its own copy of the reference's host Tracer: the same
    sections, counters and report lines (times masked)."""
    from blazeseq_tpu import tracing as ref

    assert tracing.Tracer is not ref.Tracer
    assert tracing.global_tracer() is tracing.global_tracer()
    reports = []
    for mod in (tracing, ref):
        t = mod.Tracer()
        for _ in range(2):
            with t.section("parse"):
                with t.section("scan"):
                    t.count("reads", 3)
        t.count("batches")
        assert t.calls == {"parse": 2, "scan": 2}
        assert t.counters == {"reads": 6, "batches": 1}
        assert t.rate("parse", 0) == 0.0 and t.rate("none", 10) == 0.0
        lines = t.report().splitlines()
        reports.append([lines[0]] + [
            " ".join(w for w in ln.split() if not w[:1].isdigit()
                     or w.startswith("(")) for ln in lines[1:3]] + lines[3:])
    assert reports[0] == reports[1]
    assert reports[0][1:3] == ["parse (2 calls)", "scan (2 calls)"]


def _trace_names(path):
    with open(path) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]}


def test_device_trace_writes_a_chrome_trace(tmp_path):
    out = tmp_path / "trace"
    x = torch.arange(1 << 12, dtype=torch.int32)
    with tracing.device_trace(str(out)) as d:
        assert d == str(out)
        torch.cumsum(x, 0)
    names = _trace_names(out / "trace.json")
    assert "aten::cumsum" in names


def test_device_trace_writes_when_the_block_raises(tmp_path):
    with pytest.raises(ValueError, match="inside"):
        with tracing.device_trace(str(tmp_path)):
            torch.ones(3).sum()
            raise ValueError("inside")
    assert "aten::sum" in _trace_names(tmp_path / "trace.json")
