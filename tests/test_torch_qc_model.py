"""The PyTorch port's QCModel(device="cpu").run_file_device against the
reference package's QCModel.run_file_device and run_file, on the corpora of
tests/test_device_qc_model.py, tests/test_adaptive_hist.py,
tests/test_normalize_semi_uniform.py and tests/test_ragged_qc.py plus a
trailing partial record (the mid-file failures are in
tests/test_torch_qc_fallback.py), with the tiers each corpus takes
(`tier_chunks`). Integer report fields are exact; float fields agree to rel
1e-12 (both packages derive them in float64 from the same int64 totals).
A truncated ragged file raises the reference's error.

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


def _var_ids(n, lo, hi, seed):
    """Records with ids of varying width and reads of lo..hi bases."""
    return bytes(bt.generate_variable_id_fastq_buffer(
        n, lo, hi, 2, 40, "sanger", seed=seed))


def _record_start(buf, frac):
    """Offset of the first record start at or after frac * len(buf)."""
    nl = np.flatnonzero(np.frombuffer(buf, np.uint8) == 10)
    k = int(np.searchsorted(nl, int(len(buf) * frac)))
    return int(nl[(k // 4 + 1) * 4 - 1]) + 1


def _corpus(name):
    """(bytes, file suffix, chunk_mb, max_read_len) of each named corpus."""
    if name == "semi_multichunk":
        return _var_ids(10_000, 100, 100, 1), ".fastq", 1, 128
    if name == "semi_length_blocks":
        # the re-peek restarts the tier at the new read length
        return (_var_ids(3000, 100, 100, 1) + _var_ids(1000, 60, 60, 2),
                ".fastq", 1, 128)
    if name == "semi_wide_id":
        # an id wider than the peeked bound mid-file: the re-peek widens it
        v = _var_ids(3000, 100, 100, 1)
        big = (b"@" + b"X" * 120 + b"\n" + b"A" * 100 + b"\n+\n"
               + b"I" * 100 + b"\n")
        cut = _record_start(v, 0.5)
        return v[:cut] + big + v[cut:], ".fastq", 4, 128
    if name == "semi_ragged_tail":
        return (_var_ids(3000, 100, 100, 1) + _var_ids(400, 40, 90, 3),
                ".fastq", 1, 128)
    if name == "uniform_then_varid":
        # the uniform proof fails at the first variable id: semi from there
        return (_uniform(10_000, 60) + _var_ids(3000, 60, 60, 4), ".fastq",
                1, 128)
    if name == "ragged_multichunk":
        return _var_ids(9000, 80, 120, 21), ".fastq", 1, 128
    if name == "ragged_short_records":
        # records far shorter than the width: the reference's ragged step
        # reports `fallback` at its default slot capacity
        return _var_ids(3000, 10, 20, 31), ".fastq", 1, 128
    if name == "ragged_long_reads":
        return _var_ids(500, 200, 300, 27), ".fastq", 1, 128
    if name == "ragged_invalid_byte":
        buf = bytearray(_var_ids(6000, 80, 120, 23))
        at = _record_start(bytes(buf), 0.8)
        qual = at + [i for i, c in enumerate(buf[at:at + 2000])
                     if c == 10][2] + 3
        buf[qual] = 0x20  # below the sanger range: one error read
        return bytes(buf), ".fastq", 1, 128
    if name == "ragged_len_peek_miss":
        # the 64 KiB head holds lengths 80-120 only; later reads are longer
        return (_var_ids(600, 80, 120, 5) + _var_ids(300, 150, 200, 6),
                ".fastq", 1, 256)
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
    if name == "uniform_short_tail":
        # three full 1 MiB chunks of 176-byte records, then a chunk of four
        # whole records, then the last record without its final newline
        rows = (1 << 20) // 176
        return _uniform(3 * rows + 5, 80)[:-1], ".fastq", 1, 128
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
           "trailing_partial", "uniform_short_tail", "long_reads", "empty",
           "binned_peek",
           "binned_overflow", "full_range", "semi_multichunk",
           "semi_length_blocks", "semi_wide_id", "semi_ragged_tail",
           "uniform_then_varid", "ragged_multichunk", "ragged_short_records",
           "ragged_long_reads", "ragged_invalid_byte",
           "ragged_len_peek_miss"]
# the tiers each corpus of CORPORA takes (those with a nonzero count):
# semi for one read length with ids of varying width, ragged for mixed
# lengths, host only for invalid chunks and partial tails; gzip input runs
# the stream tiers (uniform, or ragged for mixed lengths)
TIERS = {
    "clean_multichunk": {"uniform"}, "nonuniform": {"ragged"},
    "gzip": {"uniform"}, "gzip_nonuniform": {"ragged"},
    "trailing_partial": {"uniform", "host"},
    "uniform_short_tail": {"uniform", "host"}, "long_reads": {"uniform"},
    "empty": set(), "binned_peek": {"uniform"},
    "binned_overflow": {"uniform"}, "full_range": {"uniform"},
    "semi_multichunk": {"semi"}, "semi_length_blocks": {"semi"},
    "semi_wide_id": {"semi"}, "semi_ragged_tail": {"semi", "ragged"},
    "uniform_then_varid": {"uniform", "semi"},
    "ragged_multichunk": {"ragged"}, "ragged_short_records": {"ragged"},
    "ragged_long_reads": {"ragged"},
    "ragged_invalid_byte": {"ragged", "host"},
    "ragged_len_peek_miss": {"ragged"},
}
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
    passes = []  # one entry per pass over the file
    once = port._run_file_device_once

    def counted(*a, **k):
        passes.append(1)
        return once(*a, **k)

    port._run_file_device_once = counted
    rep = port.run_file_device(p, chunk_mb=chunk_mb)
    ref = JaxQCModel(quality_schema="sanger", max_read_len=width)
    if ref_entry == "run_file":
        _assert_reports_equal(rep, ref.run_file(p))
    else:
        _assert_reports_equal(rep, ref.run_file_device(p, chunk_mb=chunk_mb))
    tiers = port.tier_chunks
    if name in TIERS:
        assert {k for k, v in tiers.items() if v} == TIERS[name], tiers
    if name in ("clean_multichunk", "semi_multichunk", "semi_length_blocks",
                "ragged_multichunk"):
        assert max(tiers.values()) > 1, tiers
    if name == "uniform_short_tail":
        assert (tiers["uniform"], tiers["host"]) == (4, 1), tiers
    if name.startswith(("midfile", "inflight")):
        assert tiers["host"] > 0, tiers
    if name.startswith(("midfile", "inflight", "ragged_invalid")):
        assert rep.error_reads == 1
    if name == "ragged_len_peek_miss":
        # the ragged tier takes full-bin histograms: lengths the head peek
        # misses cost no second pass (the reference re-runs the file)
        assert len(passes) == 1
        assert rep.length_hist[150:201].sum() == 300
    if name == "binned_peek":
        assert (2, 12, 23, 37) in port._hist_his  # eq-mode engaged
        assert rep.qual_hist[LUT].sum() == rep.qual_hist.sum()
    if name == "binned_overflow":
        assert port._hist_his == set()  # cleared by the full-bin re-run
        assert len(passes) == 2
        assert rep.qual_hist[8] == 40 * 100


@pytest.mark.parametrize("ref_entry", ["run_file", "run_file_device"])
@pytest.mark.parametrize("name", CORPORA)
def test_report_matches_reference(tmp_path, name, ref_entry):
    check_corpus(tmp_path, name, ref_entry)


@pytest.mark.parametrize("cut", [51, 130, 230])
def test_truncated_ragged_file_raises_like_reference(tmp_path, cut):
    """A ragged file cut inside its last record: the ragged tier takes the
    complete records and the host route takes the cut one, which counts as
    an error read (cut in the quality line) or raises the reference's error
    with its message (cut in the seq or id line)."""
    buf = _var_ids(3000, 80, 120, 33)
    p = str(tmp_path / "trunc.fastq")
    with open(p, "wb") as f:
        f.write(buf[:len(buf) - cut])

    def outcome(run):
        try:
            rep = run()
        except Exception as e:  # compared by class name and message
            return type(e).__name__, str(e)
        return rep.reads, rep.error_reads

    port = QCModel(quality_schema="sanger", device="cpu")
    got = outcome(lambda: port.run_file_device(p, chunk_mb=1))
    want = outcome(lambda: JaxQCModel(quality_schema="sanger")
                   .run_file_device(p, chunk_mb=1))
    assert got == want
    assert got == ((3000, 1) if cut == 51 else ("ParseError", got[1]))
    assert port.tier_chunks["ragged"] == 1


def test_kernel_b_refused_layout_goes_to_ragged_tier(tmp_path, monkeypatch):
    """Deliberate difference: a uniform layout that kernel B refuses on the
    card (more than 512 stats columns, or a tile ring over its shared
    memory; `QCModel._kernel_takes`) goes to the ragged tier, where the
    reference stays on its uniform kernel. The report is equal. The CPU
    takes every layout, so the refusal is forced here;
    tests/test_torch_ragged_qc.py::test_kernel_b_refused_layout_on_card
    meets a real one."""
    monkeypatch.setattr(QCModel, "_kernel_takes", lambda self, rs, n: False)
    raw, _, chunk_mb, width = _corpus("clean_multichunk")
    p = str(tmp_path / "u.fastq")
    with open(p, "wb") as f:
        f.write(raw)
    port = QCModel(quality_schema="sanger", max_read_len=width, device="cpu")
    rep = port.run_file_device(p, chunk_mb=chunk_mb)
    ref = JaxQCModel(quality_schema="sanger", max_read_len=width)
    _assert_reports_equal(rep, ref.run_file_device(p, chunk_mb=chunk_mb))
    assert {k for k, v in port.tier_chunks.items() if v} == {"ragged"}


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
