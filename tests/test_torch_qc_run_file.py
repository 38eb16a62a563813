"""Parity: the PyTorch port's host-parse path, QCModel(device="cpu")
.run_file / run_reader / run_parser (blazeseq_tpu_torch/models/qc.py),
against blazeseq_tpu/models/qc.py::QCModel.run_file on the same files.

The corpus has reads of 30-160 bp (some longer than the 128 width),
planted adapters, duplicated reads and one invalid quality byte (an error
read), plain and gzip. Alignment, adapters, duplicates (with a
dup_track_limit that cuts a batch) and quartiles run alone and together;
the whole to_dict() must be equal, and so must the nw_scores arrays.

Also: the port loads no JAX while NWAligner and run_file(align_to=...) run
on the CPU, run_parser refuses a mesh and an unresolved 'auto' schema, and
QCModel(device="cuda") matches the CPU on the card (skipped without one).
"""

import gzip
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import blazeseq_tpu as bt
from blazeseq_tpu.fastq.parser import FastqParser, ParserConfig
from blazeseq_tpu.io.readers import MemoryReader
from blazeseq_tpu_torch import QCModel
from blazeseq_tpu_torch.ops import nw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ADAPTERS = [b"AGATCGGAAGAG", b"ctgtctcttata"]
ALIGN_TO = b"GATTACAGGCTTAACGTAGGATCCAGTTACAGATTACAGGTCCATG"
OPTIONS = {
    "align": dict(align_to=ALIGN_TO),
    "adapters": dict(adapters=ADAPTERS),
    "dups": dict(track_duplicates=True, dup_track_limit=700),
    "quartiles": dict(track_quartiles=True),
    "all": dict(align_to=ALIGN_TO, adapters=ADAPTERS, track_duplicates=True,
                dup_track_limit=700, track_quartiles=True),
}
COMMON = dict(quality_schema="sanger", batch_size=256, max_read_len=128)


def _corpus(n=1500, seed=0) -> bytes:
    """Reads of 30-160 bp with adapters planted in every 7th read, every
    11th read a copy of one of five templates, and one quality byte below
    the sanger range."""
    rng = np.random.default_rng(seed)
    buf = bytes(bt.generate_synthetic_fastq_buffer(n, 30, 160, 2, 40,
                                                   "sanger"))
    lines = buf.split(b"\n")
    templates = [lines[4 * t + 1] for t in range(5)]
    for r in range(n):
        s = bytearray(lines[4 * r + 1])
        if r % 11 == 10:
            s = bytearray(templates[r % 5])
            lines[4 * r + 3] = lines[4 * (r % 5) + 3]
        elif r % 7 == 3:
            a = ADAPTERS[r % 2]
            j = int(rng.integers(0, len(s) - len(a) + 1))
            s[j:j + len(a)] = a
        lines[4 * r + 1] = bytes(s)
    e = 4 * min(600, n // 2) + 3
    q = bytearray(lines[e])
    q[5] = 0x20  # below the sanger range: one error read
    lines[e] = bytes(q)
    return b"\n".join(lines)


def _write(tmp_path, kind):
    raw = _corpus()
    p = tmp_path / ("c.fastq.gz" if kind == "gz" else "c.fastq")
    p.write_bytes(gzip.compress(raw, 5) if kind == "gz" else raw)
    return str(p)


def _assert_same(port, ref):
    dp, dr = port.to_dict(), ref.to_dict()
    assert dp == dr, {k: (dp.get(k), dr.get(k)) for k in set(dp) | set(dr)
                      if dp.get(k) != dr.get(k)}
    assert str(port) == str(ref)
    if ref.nw_scores is None:
        assert port.nw_scores is None
    else:
        assert port.nw_scores.dtype == np.int32
        np.testing.assert_array_equal(ref.nw_scores, port.nw_scores)
    for a, st in (ref.adapter_stats or {}).items():
        for x, y in zip(st, port.adapter_stats[a]):
            np.testing.assert_array_equal(np.asarray(x), y)
    for k in ("duplication_levels", "quality_quartiles", "per_pos_qual_hist"):
        x, y = getattr(ref, k), getattr(port, k)
        assert (x is None) == (y is None), k
        if x is not None:
            np.testing.assert_array_equal(np.asarray(x), y, err_msg=k)
    assert port.overrepresented == ref.overrepresented


@pytest.mark.parametrize("kind,opts", [
    ("plain", "align"), ("plain", "adapters"), ("plain", "dups"),
    ("plain", "quartiles"), ("plain", "all"), ("gz", "all")])
def test_run_file_matches_reference(tmp_path, kind, opts):
    models = pytest.importorskip("blazeseq_tpu.models")
    path = _write(tmp_path, kind)
    kw = dict(COMMON, **OPTIONS[opts])
    port = QCModel(device="cpu", **kw).run_file(path)
    ref = models.QCModel(**kw).run_file(path)
    _assert_same(port, ref)
    assert port.reads == 1500 and port.error_reads == 1
    if "align_to" in kw:
        assert port.nw_scores.shape == (1500,)
    if "adapters" in kw:
        assert all(int(st.reads_with_adapter) > 0
                   for st in port.adapter_stats.values())
    if kw.get("track_duplicates"):
        assert port.duplication_levels.sum() > 0
        assert port.overrepresented  # the five templates


def test_run_parser_and_reader_match_run_file(tmp_path):
    path = _write(tmp_path, "plain")
    kw = dict(COMMON, **OPTIONS["all"])
    want = QCModel(device="cpu", **kw).run_file(path)
    with open(path, "rb") as f:
        raw = f.read()
    parser = FastqParser(MemoryReader(raw), config=ParserConfig())
    _assert_same(QCModel(device="cpu", **kw).run_parser(parser), want)
    _assert_same(QCModel(device="cpu", **kw).run_reader(MemoryReader(raw)),
                 want)


def test_empty_file_matches_reference(tmp_path):
    models = pytest.importorskip("blazeseq_tpu.models")
    p = tmp_path / "e.fastq"
    p.write_bytes(b"")
    kw = dict(COMMON, **OPTIONS["all"])
    port = QCModel(device="cpu", **kw).run_file(str(p))
    _assert_same(port, models.QCModel(**kw).run_file(str(p)))
    assert port.reads == 0 and port.nw_scores is None


def test_run_parser_refusals(tmp_path):
    path = _write(tmp_path, "plain")
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        QCModel(device="cpu", mesh=object()).run_file(path)
    with pytest.raises(ValueError, match="auto"):
        QCModel(quality_schema="auto", device="cpu").run_reader(
            MemoryReader(b"@r\nACGT\n+\nIIII\n"))
    # 'auto' resolves from the file head on the path entry point
    rep = QCModel(quality_schema="auto", device="cpu").run_file(path)
    assert rep.reads == 1500


@pytest.mark.parametrize("qual_hist_2d", [False, True])
def test_accumulator_derived_panels_match_reference(qual_hist_2d):
    """mean_read_length, modal_read_length and the quartiles (or their
    refusal when the distribution was not tracked) over two batches."""
    ref_stats = pytest.importorskip("blazeseq_tpu.ops.stats")
    from blazeseq_tpu_torch.ops import stats as port_stats

    parser = FastqParser(MemoryReader(_corpus(600)), config=ParserConfig())
    ref_acc, port_acc = ref_stats.QCAccumulator(), port_stats.QCAccumulator()
    for pb in parser.padded_batches(256, max_len=128, pad_records_to=256):
        st = ref_stats.qc_stats(pb.seq, pb.qual, pb.lengths, np.int32(33),
                                n_records=np.int32(pb.n_records),
                                qual_hist_2d=qual_hist_2d)
        ref_acc.add(st)
        port_acc.add(port_stats.qcstats_from_numpy(st))
    assert port_acc.mean_read_length() == ref_acc.mean_read_length()
    assert port_acc.modal_read_length() == ref_acc.modal_read_length()
    if qual_hist_2d:
        np.testing.assert_array_equal(
            ref_acc.per_position_quality_quartiles(),
            port_acc.per_position_quality_quartiles())
    else:
        with pytest.raises(ValueError, match="track_quartiles=True"):
            port_acc.per_position_quality_quartiles()


def test_alignment_path_loads_no_jax(tmp_path):
    p = tmp_path / "a.fastq"
    p.write_bytes(_corpus(400))
    code = (
        "import sys\n"
        "import blazeseq_tpu as bt\n"
        "from blazeseq_tpu_torch import NWAligner, QCModel\n"
        "r = QCModel(quality_schema='sanger', align_to=%r, adapters=[b'AC'],"
        " track_duplicates=True, track_quartiles=True, batch_size=128,"
        " device='cpu').run_file(%r)\n"
        "assert r.reads == 400 and r.nw_scores.shape == (400,), r\n"
        "batch = bt.FastqParser(bt.MemoryReader(open(%r, 'rb').read()))"
        ".next_batch(50)\n"
        "assert NWAligner(%r, device='cpu').verify_batch(batch)\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "print('ok')\n" % (ALIGN_TO, str(p), str(p), ALIGN_TO))
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("kind", ["plain", "gz"])
def test_run_file_on_card_matches_cpu(tmp_path, kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    path = _write(tmp_path, kind)
    kw = dict(COMMON, **OPTIONS["all"])
    before = nw.nw_scores.launches
    gpu = QCModel(device="cuda", **kw).run_file(path)
    assert nw.nw_scores.launches - before == -(-1500 // 256)
    _assert_same(gpu, QCModel(device="cpu", **kw).run_file(path))
