"""The PyTorch port's QCModel(device="cpu").run_file_device against the
reference package's QCModel.run_file_device and run_file, on the corpora of
tests/test_device_qc_model.py and tests/test_adaptive_hist.py plus a
trailing partial record (the mid-file failures are in
tests/test_torch_qc_fallback.py). Integer report fields
are exact; float fields agree to rel 1e-12 (both packages derive them in
float64 from the same int64 totals).

Also: the port loads no JAX, QCModel(device="cuda") refuses to run without
CUDA, and a CUDA dispatch whose kernel library cannot load raises instead of
answering with the plain version.
"""

import gzip
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import blazeseq_tpu as bt
from blazeseq_tpu.models import QCModel as JaxQCModel
from blazeseq_tpu_torch import QCModel, _kernels
from blazeseq_tpu_torch.ops import uniform_qc as uqc_mod
from blazeseq_tpu_torch.ops import validate as val_mod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LUT = np.array([2, 12, 23, 37])
EDGES = np.array([7, 18, 30])
INT_FIELDS = ("reads", "bases", "error_reads", "base_counts", "qual_hist",
              "length_hist", "gc_hist", "mean_qual_hist",
              "per_pos_base_counts", "per_pos_count")
FLOAT_FIELDS = ("gc_fraction", "mean_quality", "per_position_mean_quality")


def _assert_reports_equal(port, ref):
    for k in INT_FIELDS:
        a, b = np.asarray(getattr(port, k)), np.asarray(getattr(ref, k))
        assert np.array_equal(a, b), k
    for k in FLOAT_FIELDS:
        a, b = getattr(port, k), getattr(ref, k)
        assert np.asarray(a) == pytest.approx(np.asarray(b), rel=1e-12), k
    dp, dr = port.to_dict(), ref.to_dict()
    assert dp == dr, {k: (dp[k], dr.get(k)) for k in dp if dp[k] != dr.get(k)}


def _uniform(n, L=60, seed=None):
    return bytes(bt.generate_synthetic_fastq_buffer(n, L, L, 2, 40, "sanger"))


def _corrupt_quality(buf, rec_idx, col=2):
    lines = bytes(buf).split(b"\n")
    qpos = sum(len(ln) + 1 for ln in lines[: rec_idx * 4 + 3])
    b = bytearray(buf)
    b[qpos + col] = 0x20  # below the sanger range: one error read
    return bytes(b)


def _binned(n=4000, L=100):
    buf = _uniform(n, L)
    arr = np.frombuffer(buf, np.uint8)
    nl = np.flatnonzero(arr == 10)
    rs = int(nl[3]) + 1
    arr = arr.reshape(-1, rs).copy()
    o3 = int(nl[2])
    q = arr[:, o3 + 1:rs - 1].astype(np.int32) - 33
    arr[:, o3 + 1:rs - 1] = (LUT[np.searchsorted(EDGES, q)] + 33).astype(
        np.uint8)
    return arr, o3, rs


def _corpus(name):
    """(bytes, file suffix, chunk_mb, max_read_len) of each named corpus."""
    if name == "clean_multichunk":
        return _uniform(8000, 80), ".fastq", 1, 128
    if name == "midfile_quality_error":
        return _corrupt_quality(_uniform(2000), 1500, 5), ".fastq", 1, 64
    if name == "nonuniform":
        return bytes(bt.generate_synthetic_fastq_buffer(
            500, 40, 120, 2, 40, "sanger")), ".fastq", 256, 128
    if name == "gzip":
        return gzip.compress(_uniform(2500, 64), 5), ".fastq.gz", 1, 64
    if name == "gzip_nonuniform":
        return gzip.compress(bytes(bt.generate_synthetic_fastq_buffer(
            400, 30, 90, 2, 40, "sanger")), 5), ".fastq.gz", 256, 128
    if name == "trailing_partial":
        # the last record loses its final newline: not a whole rs block
        return _uniform(2500, 70)[:-1], ".fastq", 1, 128
    if name == "long_reads":
        return _uniform(800, 300), ".fastq", 1, 128
    if name == "empty":
        return b"", ".fastq", 1, 128
    if name.startswith("inflight_"):
        # ~4 MB at 60 bp -> several 1 MB chunks, so the failure lands
        # while later chunks are already dispatched
        frac = float(name.split("_")[1])
        n = 30_000
        return _corrupt_quality(_uniform(n), int(n * frac)), ".fastq", 1, 64
    if name == "binned_peek":
        return _binned()[0].tobytes(), ".fastq", 1, 128
    if name == "binned_overflow":
        arr, o3, rs = _binned()
        arr[-40:, o3 + 1:rs - 1] = 33 + 8  # a phred the head never saw
        return arr.tobytes(), ".fastq", 1, 128
    if name == "full_range":
        return _uniform(3000, 100), ".fastq", 1, 128
    raise KeyError(name)


CORPORA = ["clean_multichunk", "nonuniform", "gzip", "gzip_nonuniform",
           "trailing_partial", "long_reads", "empty", "binned_peek",
           "binned_overflow", "full_range"]
# proof failures mid-file; tests/test_torch_qc_fallback.py runs these
FAILURE_CORPORA = ["midfile_quality_error", "inflight_0.02", "inflight_0.55",
                   "inflight_0.99"]


def check_corpus(tmp_path, name, ref_entry):
    """Run one corpus through the port on the CPU and through the
    reference's `ref_entry`, and compare the reports."""
    raw, suffix, chunk_mb, width = _corpus(name)
    p = str(tmp_path / ("c" + suffix))
    with open(p, "wb") as f:
        f.write(raw)
    port = QCModel(quality_schema="sanger", max_read_len=width, device="cpu")
    rep = port.run_file_device(p, chunk_mb=chunk_mb)
    ref = JaxQCModel(quality_schema="sanger", max_read_len=width)
    if ref_entry == "run_file":
        _assert_reports_equal(rep, ref.run_file(p))
    else:
        _assert_reports_equal(rep, ref.run_file_device(p, chunk_mb=chunk_mb))
    tiers = port.tier_chunks
    if name in ("clean_multichunk", "long_reads", "binned_peek",
                "full_range"):
        assert tiers["uniform"] >= 1 and tiers["host"] == 0, tiers
    if name == "clean_multichunk":
        assert tiers["uniform"] > 1, tiers
    if name in ("nonuniform", "gzip", "gzip_nonuniform"):
        assert tiers["uniform"] == 0 and tiers["host"] > 0, tiers
    if name.startswith(("midfile", "inflight", "trailing")):
        assert tiers["host"] > 0, tiers
    if name.startswith(("midfile", "inflight")):
        assert rep.error_reads == 1
    if name == "binned_peek":
        assert (2, 12, 23, 37) in port._hist_his  # eq-mode engaged
        assert rep.qual_hist[LUT].sum() == rep.qual_hist.sum()
    if name == "binned_overflow":
        assert port._hist_his == set()  # cleared by the full-bin re-run
        assert rep.qual_hist[8] == 40 * 100


@pytest.mark.parametrize("ref_entry", ["run_file", "run_file_device"])
@pytest.mark.parametrize("name", CORPORA)
def test_report_matches_reference(tmp_path, name, ref_entry):
    check_corpus(tmp_path, name, ref_entry)


def test_auto_schema_matches_reference(tmp_path):
    p = str(tmp_path / "a.fastq")
    with open(p, "wb") as f:
        f.write(_uniform(2000, 70))
    port = QCModel(quality_schema="auto", device="cpu")
    rep = port.run_file_device(p, chunk_mb=1)
    ref = JaxQCModel(quality_schema="auto")
    _assert_reports_equal(rep, ref.run_file(p))
    assert (port.schema.LOWER, port.schema.UPPER, port.schema.OFFSET) == (
        ref.schema.LOWER, ref.schema.UPPER, ref.schema.OFFSET)


@pytest.mark.parametrize("kw", [
    dict(adapters=[b"AGATCGGAAGAG"]), dict(track_duplicates=True),
    dict(align_to=b"ACGTACGT"), dict(track_quartiles=True),
    dict(mesh=object())])
def test_unsupported_features_raise(tmp_path, kw):
    p = tmp_path / "f.fastq"
    p.write_bytes(_uniform(50, 40))
    with pytest.raises(ValueError, match="covers core QC"):
        QCModel(device="cpu", **kw).run_file_device(str(p))


def test_slice_loads_no_jax(tmp_path):
    p = tmp_path / "u.fastq"
    p.write_bytes(_corrupt_quality(_uniform(3000, 50), 2000))
    code = (
        "import sys\n"
        "from blazeseq_tpu_torch import QCModel\n"
        "r = QCModel(quality_schema='sanger', device='cpu')"
        ".run_file_device(%r, chunk_mb=1)\n"
        "assert r.reads == 3000 and r.error_reads == 1, r\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "print('ok')\n" % str(p))
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_cuda_model_refused_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        QCModel()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        QCModel(device="cuda:0")


class _LooksCuda(torch.Tensor):
    """A CPU tensor that reports is_cuda, to reach the CUDA dispatch branch
    without a card."""

    @property
    def is_cuda(self):
        return True


def _looks_cuda(a):
    return torch.Tensor._make_subclass(_LooksCuda, torch.from_numpy(a))


def _fail_to_load():
    raise RuntimeError("kernel library unavailable (test)")


def test_cuda_dispatch_raises_when_kernels_cannot_load(monkeypatch):
    monkeypatch.setattr(_kernels, "load", _fail_to_load)

    def twin_must_not_run(*a, **k):
        raise AssertionError("plain version reached from the CUDA branch")

    monkeypatch.setattr(uqc_mod, "_uniform_qc_raw_torch", twin_must_not_run)
    monkeypatch.setattr(val_mod, "validate_decode_torch", twin_must_not_run)
    before = (uqc_mod.uniform_qc.launches, val_mod.validate_decode.launches)
    buf = np.frombuffer(_uniform(8, 40), np.uint8)
    rs = len(buf) // 8
    nl = np.flatnonzero(buf[:rs] == 10)
    chunk = _looks_cuda(buf.reshape(8, rs).copy())
    with pytest.raises(RuntimeError, match="kernel library unavailable"):
        uqc_mod.uniform_qc(chunk, chunk.numel(), rs=rs, o1=int(nl[0]),
                           o2=int(nl[1]), o3=int(nl[2]), width=128, q_lo=33,
                           q_hi=126, offset=33)
    seq = _looks_cuda(np.zeros((4, 128), np.uint8))
    lengths = _looks_cuda(np.full(4, 10, np.int32))
    from blazeseq_tpu.fastq.quality import parse_schema

    with pytest.raises(RuntimeError, match="kernel library unavailable"):
        val_mod.validate_decode(seq, seq, lengths, parse_schema("sanger"))
    # a launch that never happened is not counted
    assert (uqc_mod.uniform_qc.launches,
            val_mod.validate_decode.launches) == before
