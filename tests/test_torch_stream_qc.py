"""The stream tiers of the PyTorch port's QCModel.run_file_device (gzip and
BGZF input: the uniform stream tier on kernel B's plain version, the ragged
stream tier on the ragged kernel's) against the reference package's
run_file_device and the port's own run_file, on the same bytes, with the
tiers each corpus takes (`tier_chunks`, exact sets). The port runs with
device="cpu"; the reference on JAX's CPU backend. Integer report fields are
exact; float fields agree to rel 1e-12 (both packages derive them in
float64 from the same int64 totals).

Also: a gzip cut inside a member and a gzip whose FASTQ ends inside a record
raise the same exception class from run_file_device as from run_file; and a
last record cut inside its quality line (no final newline), plain and
gzipped, gives the reference's plain-file report on every route, run after
run.
"""

import gzip
import json
import os
import subprocess
import sys
import zlib

import numpy as np
import pytest

import blazeseq_tpu as bt
from blazeseq_tpu.io.writers import BGZFWriter
from blazeseq_tpu.models import QCModel as JaxQCModel
from blazeseq_tpu_torch import QCModel

from .test_torch_qc_model import (_assert_reports_equal, _corrupt_quality,
                                  _record_start, _uniform, _var_ids)


def _big_record(n_bases):
    return (b"@big\n" + b"ACGT" * (n_bases // 4) + b"\n+\n"
            + b"I" * (n_bases // 4 * 4) + b"\n")


def _stream(name):
    """(compressed bytes, file suffix, chunk_mb, max_read_len) of each
    named stream; every one but the BGZF one is gzip."""
    if name == "uniform_multichunk":
        raw = _uniform(16_000, 80)  # ~3.3 MB: four chunks of 1 MiB
    elif name == "uniform_in_head":
        raw = _uniform(200, 60)  # the stream ends inside the 64 KiB head
    elif name == "uniform_then_varid":
        # the proof fails at the first variable id: the ragged stream tier
        # takes the rest of the stream from the failed chunk's start
        raw = _uniform(10_000, 60) + _var_ids(3000, 60, 60, 4)
    elif name == "inflight_failure":
        # ~4.5 MB at 60 bp: the chunk with the bad quality byte fails while
        # the two chunks after it are in flight; the ragged stream tier's
        # first chunk holds the same bytes and is rejected too, so the host
        # route takes it and the rest
        n = 30_000
        raw = _corrupt_quality(_uniform(n, 60), int(n * 0.55))
        return gzip.compress(raw, 1), ".fastq.gz", 1, 64
    elif name == "varid_then_bad_byte":
        # uniform, then variable ids from ~1.5 MB (the ragged stream tier),
        # then a bad quality byte in its second chunk (the host route)
        v = _var_ids(12_000, 60, 60, 4)
        raw = _uniform(10_000, 60) + _corrupt_quality(v, 9600)
    elif name == "ragged_multichunk":
        raw = _var_ids(9000, 80, 120, 21)
    elif name == "long_reads":
        raw = _var_ids(500, 200, 300, 27)  # longer than max_read_len
    elif name == "short_reads":
        raw = _var_ids(3000, 10, 20, 31)
    elif name == "record_over_chunk":
        # one record of ~1.4 MB, larger than a 1 MiB ragged chunk: the host
        # route takes it and raises, as the reference and run_file do,
        # since it also exceeds the host parser's record buffer
        v = _var_ids(3000, 80, 120, 41)
        cut = _record_start(v, 0.5)
        raw = v[:cut] + _big_record(700_000) + v[cut:]
    elif name == "empty":
        return gzip.compress(b""), ".fastq.gz", 1, 128
    elif name == "multi_member":
        u = _uniform(12_000, 70)
        return (gzip.compress(u[:1_000_000], 1)
                + gzip.compress(u[1_000_000:], 6)), ".fastq.gz", 1, 128
    elif name == "bgzf":
        return None, ".fastq.bgz", 1, 128  # written by _write
    else:
        raise KeyError(name)
    return gzip.compress(raw, 1), ".fastq.gz", 1, 128


def _write(tmp_path, name):
    comp, suffix, chunk_mb, width = _stream(name)
    p = str(tmp_path / ("s" + suffix))
    if comp is None:
        w = BGZFWriter(p)
        w.write(_uniform(16_000, 80))
        w.close()
    else:
        with open(p, "wb") as f:
            f.write(comp)
    return p, chunk_mb, width


STREAMS = ["uniform_multichunk", "uniform_in_head", "uniform_then_varid",
           "inflight_failure", "varid_then_bad_byte", "ragged_multichunk", "long_reads",
           "short_reads", "record_over_chunk", "empty", "multi_member",
           "bgzf", "auto_schema", "kernel_b_refused"]
# the tiers each stream takes (those with a nonzero count)
TIERS = {
    "uniform_multichunk": {"uniform"}, "uniform_in_head": {"uniform"},
    "uniform_then_varid": {"uniform", "ragged"},
    "inflight_failure": {"uniform", "host"},
    "varid_then_bad_byte": {"uniform", "ragged", "host"},
    "ragged_multichunk": {"ragged"}, "long_reads": {"ragged"},
    "short_reads": {"ragged"}, "record_over_chunk": {"ragged"},
    "empty": set(), "multi_member": {"uniform"}, "bgzf": {"uniform"},
    "auto_schema": {"uniform"}, "kernel_b_refused": {"ragged"},
}


@pytest.mark.parametrize("name", STREAMS)
def test_stream_report_matches_reference(tmp_path, monkeypatch, name):
    schema = "sanger"
    if name == "auto_schema":
        p, chunk_mb, width = _write(tmp_path, "uniform_multichunk")
        schema = "auto"
    elif name == "kernel_b_refused":
        # Deliberate difference: a layout that kernel B refuses on the card
        # (QCModel._kernel_takes) goes to the ragged stream tier, where the
        # reference stays on its uniform kernel. The CPU takes every
        # layout, so the refusal is forced here.
        monkeypatch.setattr(QCModel, "_kernel_takes",
                            lambda self, rs, n: False)
        p, chunk_mb, width = _write(tmp_path, "uniform_multichunk")
    else:
        p, chunk_mb, width = _write(tmp_path, name)
    port = QCModel(quality_schema=schema, max_read_len=width, device="cpu")
    ragged_runs = []  # the rebuilt stream each ragged stream tier starts on
    ragged = port._run_ragged_stream

    def spy(head, reader, *a):
        ragged_runs.append(len(head))
        return ragged(head, reader, *a)

    port._run_ragged_stream = spy
    rep = _outcome(lambda: port.run_file_device(p, chunk_mb=chunk_mb))
    tiers = {k for k, v in port.tier_chunks.items() if v}
    ref = JaxQCModel(quality_schema=schema, max_read_len=width)
    want = _outcome(lambda: ref.run_file_device(p, chunk_mb=chunk_mb))
    host = _outcome(lambda: QCModel(quality_schema=schema, max_read_len=width,
                                    device="cpu").run_file(p))
    if name == "record_over_chunk":
        assert rep == want == host
        assert rep[0] == "ParseError" and "buffer capacity" in rep[1], rep
    else:
        _assert_reports_equal(rep, want)
        _assert_reports_equal(rep, host)
    assert tiers == TIERS[name], port.tier_chunks
    if name in ("uniform_multichunk", "ragged_multichunk", "bgzf"):
        assert max(port.tier_chunks.values()) > 1, port.tier_chunks
    if name in ("inflight_failure", "varid_then_bad_byte"):
        assert rep.error_reads == 1
    if "uniform" in tiers and tiers != {"uniform"}:
        # a proof failure hands the rebuilt stream to the ragged stream tier
        assert ragged_runs == [0], ragged_runs
    if name == "auto_schema":
        assert (port.schema.LOWER, port.schema.UPPER, port.schema.OFFSET) \
            == (ref.schema.LOWER, ref.schema.UPPER, ref.schema.OFFSET)


def _outcome(run):
    """A run's report, or the class name and message of what it raised."""
    try:
        return run()
    except Exception as e:  # compared by class name and message
        return type(e).__name__, str(e)


def _ends_in_sequence_line(data):
    lines = data.split(b"\n")
    return len(lines) % 4 == 2 and lines[-1] != b""


def _mid_member(raw):
    """The longest prefix of a gzip member, up to 2/3 of it, whose inflated
    bytes end inside a sequence line."""
    comp = gzip.compress(raw, 1)
    cut = len(comp) * 2 // 3
    while not _ends_in_sequence_line(
            zlib.decompressobj(31).decompress(comp[:cut])):
        cut -= 1
    return comp[:cut]


def _mid_record(raw):
    """A whole gzip member whose FASTQ ends inside a sequence line."""
    cut = len(raw) - 1
    while not _ends_in_sequence_line(raw[:cut]):
        cut -= 1
    return gzip.compress(raw[:cut], 1)


@pytest.mark.parametrize("cut", ["mid_member", "mid_record"])
@pytest.mark.parametrize("layout", ["uniform", "ragged"])
def test_truncated_stream_raises_like_run_file(tmp_path, cut, layout):
    """A gzip cut inside its member, and a whole gzip whose FASTQ stops
    inside a sequence line: the device tiers take the whole records before
    the cut and the host route raises on the cut one, with the class and
    message that run_file raises."""
    raw = (_uniform(16_000, 80) if layout == "uniform"
           else _var_ids(9000, 80, 120, 21))
    p = str(tmp_path / "t.fastq.gz")
    with open(p, "wb") as f:
        f.write((_mid_member if cut == "mid_member" else _mid_record)(raw))
    port = QCModel(quality_schema="sanger", max_read_len=128, device="cpu")
    got = _outcome(lambda: port.run_file_device(p, chunk_mb=1))
    want = _outcome(lambda: QCModel(
        quality_schema="sanger", max_read_len=128, device="cpu").run_file(p))
    assert isinstance(got, tuple) and got == want, (got, want)
    assert port.tier_chunks[layout] > 0, port.tier_chunks


# A last record cut inside its quality line, with no final newline: the
# uniform corpus cut by 40 bytes (111 of 150 quality bytes left) and a
# ragged one cut by 30. The missing quality bytes are zeros on every route
# of the port, as they are in the reference on the plain file: one error
# read, and qual_hist[0] counts them.
CUT_TAILS = {
    "uniform": (lambda: bt.generate_synthetic_fastq_buffer(
        12000, 150, 150, 2, 40, "sanger"), 40, 39),
    "ragged": (lambda: bt.generate_variable_id_fastq_buffer(
        14000, 20, 300, 2, 40, "sanger", seed=6), 30, 29),
}
CUT_ROUTES = {
    "device_1mb": lambda m, p: m.run_file_device(p, chunk_mb=1),
    "device": lambda m, p: m.run_file_device(p),
    "run_file": lambda m, p: m.run_file(p),
}


@pytest.fixture(scope="module")
def cut_tails(tmp_path_factory):
    """Each cut corpus as a plain file and a level-1 gzip, with the
    reference's report on the plain file (its run_file, which equals its
    run_file_device there and compiles no ragged step), computed once."""
    d = tmp_path_factory.mktemp("cut_tails")
    out = {}
    for layout, (make, cut, zeros) in CUT_TAILS.items():
        raw = bytes(make())[:-cut]
        plain, gz = str(d / (layout + ".fastq")), str(d / (layout + ".fq.gz"))
        with open(plain, "wb") as f:
            f.write(raw)
        with open(gz, "wb") as f:
            f.write(gzip.compress(raw, 1))
        want = JaxQCModel(quality_schema="sanger").run_file(plain)
        out[layout] = dict(plain=plain, gz=gz, want=want, zeros=zeros)
    return out


@pytest.mark.parametrize("route", sorted(CUT_ROUTES))
@pytest.mark.parametrize("comp", ["plain", "gz"])
@pytest.mark.parametrize("layout", sorted(CUT_TAILS))
def test_cut_quality_tail_matches_reference_plain_file(cut_tails, layout,
                                                       comp, route):
    case = cut_tails[layout]
    want = case["want"]
    assert want.error_reads == 1
    assert np.asarray(want.qual_hist)[0] == case["zeros"]
    for _ in range(2):  # the same answer run after run
        model = QCModel(quality_schema="sanger", device="cpu")
        _assert_reports_equal(CUT_ROUTES[route](model, case[comp]), want)


def test_cut_quality_tail_reference_gzip_is_a_recorded_difference(cut_tails):
    """Deliberate difference: the reference's gather reads the missing
    quality bytes past the tail, from whatever its gzip reader's buffer
    holds there, so its gzip report's quality leaves vary from run to run
    and are not compared. The leaves that do not read quality agree."""
    case = cut_tails["uniform"]
    ref_gz = JaxQCModel(quality_schema="sanger").run_file(case["gz"])
    got = QCModel(quality_schema="sanger", device="cpu").run_file(case["gz"])
    for k in ("reads", "bases", "base_counts", "length_hist",
              "per_pos_base_counts", "gc_hist"):
        assert np.array_equal(np.asarray(getattr(got, k)),
                              np.asarray(getattr(ref_gz, k))), k


_CUT_TAIL_CHILD = """
import json, sys
from blazeseq_tpu_torch import QCModel
m = QCModel(quality_schema="sanger", device="cpu")
print(json.dumps(m.run_file_device(sys.argv[1], chunk_mb=1).to_dict(),
                 sort_keys=True))
"""


def test_cut_quality_tail_same_in_two_processes(cut_tails):
    """Two processes of their own give the report of this one on the
    gzipped cut corpus (the uniform stream tier's tail)."""
    gz = cut_tails["uniform"]["gz"]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    procs = [subprocess.Popen([sys.executable, "-c", _CUT_TAIL_CHILD, gz],
                              stdout=subprocess.PIPE, env=env, cwd=repo)
             for _ in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs)
    here = QCModel(quality_schema="sanger",
                   device="cpu").run_file_device(gz, chunk_mb=1).to_dict()
    want = json.loads(json.dumps(here, sort_keys=True))
    assert [json.loads(o.decode().strip().splitlines()[-1])
            for o in outs] == [want, want]
