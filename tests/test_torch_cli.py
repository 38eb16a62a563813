"""The PyTorch port's command line (python -m blazeseq_tpu_torch) against
the reference's (python -m blazeseq_tpu), in-process on the CPU.

Each command runs through both `main`s on the same input files: the stdout
lines and every output file must be byte-equal. The cases mirror
tests/test_cli_analysis.py, tests/test_demux_merge.py and the trim/tiles
regressions of tests/test_review_regressions.py. Also: usage errors and
exit codes, the leading --torch-device option, the default "cuda" device
refusing to run without a card, and a run in a fresh interpreter that
loads no JAX. Cases named *on_card* hold the card's output against the
CPU's and skip where there is no card.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import blazeseq_tpu as bt
from blazeseq_tpu_torch.__main__ import main


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel worker processes: keep this module's
    torch CPU ops on one thread so they do not crowd the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BARCODES = (b"ACGTACGT", b"TTGGCCAA", b"GATTACAG", b"CCCCGGGG")
COMP = dict(zip(b"ACGTN", b"TGCAN"))


def _fastq(recs):
    return b"".join(b"@%s\n%s\n+\n%s\n" % r for r in recs)


def _revcomp(s):
    return bytes(COMP[b] for b in reversed(s))


def _corpus(n=600, seed=3):
    """Illumina ids over three tiles, one of four barcodes (with up to two
    errors) at the 5' end, reads of 4-150 bp with low-quality stretches."""
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        tile = (1101, 1102, 2103)[i % 3]
        rid = b"A001:8:HXX:1:%d:%d:%d 1:N:0:1" % (tile, 100 + i, 7 * i)
        ln = int(rng.integers(4, 151))
        seq = bytearray(rng.choice(np.frombuffer(b"ACGTN", np.uint8), ln))
        bc = bytearray(BARCODES[i % 4])
        for _ in range(int(rng.integers(0, 3))):
            bc[int(rng.integers(0, 8))] = int(rng.choice(list(b"ACGT")))
        seq[:8] = bc[:ln]
        q = rng.integers(35, 74, ln).astype(np.uint8)
        cut = int(rng.integers(0, ln + 1))
        q[cut:] = rng.integers(33, 45, ln - cut)
        recs.append((rid, bytes(seq), q.tobytes()))
    return _fastq(recs)


def _mates(n=300, seed=4):
    rng = np.random.default_rng(seed)
    r1, r2 = [], []
    for i in range(n):
        frag = rng.choice(np.frombuffer(b"ACGT", np.uint8),
                          int(rng.integers(60, 200))).tobytes()
        rl = int(rng.integers(30, 120))
        s1, s2 = frag[:rl], _revcomp(frag[-rl:])
        q1 = rng.integers(35, 74, len(s1)).astype(np.uint8).tobytes()
        q2 = rng.integers(35, 74, len(s2)).astype(np.uint8).tobytes()
        r1.append((b"p%d/1" % i, s1, q1))
        r2.append((b"p%d/2" % i, s2, q2))
    return r1, r2


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_inputs")
    out = {}

    def put(name, data):
        p = d / name
        p.write_bytes(data)
        out[name.split(".")[0]] = str(p)

    put("reads.fastq", _corpus())
    put("more.fastq", _corpus(n=50, seed=9))
    r1, r2 = _mates()
    put("r1.fastq", _fastq(r1))
    put("r2.fastq", _fastq(r2))
    put("il.fastq", _fastq([r for pair in zip(r1, r2) for r in pair]))
    put("short.fastq", _fastq(r1[:-1]))
    put("plain.fastq", _fastq([(b"read_0", b"ACGT", b"IIII")]))
    put("long.fastq", b"@L0\n" + b"A" * 2000 + b"\n+\n" + b"I" * 2000
        + b"\n")
    return out


def _run(entry, argv, files, out_dir, capsys):
    """Run one main; returns (exit code, stdout with out_dir masked, the
    output files' bytes)."""
    os.makedirs(out_dir, exist_ok=True)
    args = [a.format(out=out_dir, **files) for a in argv]
    capsys.readouterr()
    try:
        rc = entry(args)
    except SystemExit as e:
        rc = e.code
    text = capsys.readouterr().out.replace(out_dir, "{out}")
    blobs = {}
    for root, _, names in os.walk(out_dir):
        for name in names:
            p = os.path.join(root, name)
            with open(p, "rb") as f:
                blobs[os.path.relpath(p, out_dir)] = f.read()
    return rc, text, blobs


def _reference_main():
    pytest.importorskip("jax")
    from blazeseq_tpu.__main__ import main as ref_main

    return ref_main


COMMANDS = {
    "stats": ["stats", "{reads}"],
    "stats_device": ["stats", "--device", "{reads}"],
    "stats_panels_json": ["stats", "--json", "--adapter", "AGATCGGAAGAG",
                          "--duplicates", "--quartiles", "{reads}"],
    "stats_duplicates": ["stats", "--duplicates", "--adapter", "ACGTACGT",
                         "{reads}", "{more}"],
    "stats_html": ["stats", "--html", "{out}/qc.html", "{reads}"],
    "trim_window": ["trim", "--mode", "window", "--q", "20", "--out",
                    "{out}/t.fastq", "{reads}"],
    "trim_bwa": ["trim", "--mode", "bwa", "--out", "{out}/t.fastq",
                 "{reads}"],
    "trim_ends": ["trim", "--mode", "ends", "--q", "5", "--out",
                  "{out}/t.fastq", "{reads}"],
    "trim_two_inputs": ["trim", "--mode", "ends", "--q", "2", "--out",
                        "{out}/t.fastq", "{reads}", "{more}"],
    "trim_long_read": ["trim", "--mode", "window", "--q", "20", "--out",
                       "{out}/t.fastq", "{long}"],
    "demux": ["demux", "--barcode", "s1=ACGTACGT", "--barcode",
              "s2=TTGGCCAA", "--barcode", "GATTACAG", "--barcode",
              "s4=CCCCGGGN", "--mismatches", "1", "--out", "{out}/dm",
              "{reads}"],
    "merge": ["merge", "--min-overlap", "10", "--out", "{out}/m.fastq",
              "{r1}", "{r2}"],
    "merge_interleaved": ["merge", "--interleaved", "--out",
                          "{out}/m.fastq", "{il}"],
    "merge_unequal": ["merge", "{r1}", "{short}"],
    "tiles": ["tiles", "{reads}"],
    "tiles_non_illumina": ["tiles", "{plain}"],
    "count": ["count", "{reads}", "{r1}"],
    "filter": ["filter", "--min-len", "20", "--min-q", "20", "--out",
               "{out}/f.fastq", "{reads}"],
    "fqidx": ["fqidx", "--fetch", "3", "--count", "2", "{reads}"],
    "usage_trim": ["trim"],
    "usage_demux": ["demux", "{reads}"],
    "usage_merge": ["merge", "{r1}"],
    "help": ["--help"],
}


@pytest.mark.parametrize("name", sorted(COMMANDS))
def test_command_matches_reference(name, files, tmp_path, capsys):
    ref_main = _reference_main()
    argv = COMMANDS[name]
    want = _run(ref_main, argv, files, str(tmp_path / "ref"), capsys)
    got = _run(lambda a: main(a, device="cpu"), argv, files,
               str(tmp_path / "port"), capsys)
    if name == "help":  # each package prints its own help text
        assert got[0] == want[0] == 0 and "--torch-device" in got[1]
        return
    assert got == want
    rc, text, blobs = got
    if name.startswith("usage"):
        assert rc == 2
    elif name == "merge_unequal":
        assert rc == 1
    else:
        assert rc == 0 and text


def test_outputs_are_what_the_commands_say(files, tmp_path, capsys):
    out = str(tmp_path)
    rc, text, blobs = _run(lambda a: main(a, device="cpu"),
                           COMMANDS["demux"], files, out, capsys)
    counts = [int(line.rsplit("\t", 1)[1]) for line in text.splitlines()]
    assert sum(counts) == 600 and len(counts) == 5
    for name, c in zip(("s1", "s2", "sample3", "s4", "unassigned"), counts):
        assert blobs["dm/%s.fastq" % name].count(b"\n") == 4 * c
    rc, text, blobs = _run(lambda a: main(a, device="cpu"),
                           COMMANDS["tiles"], files, out, capsys)
    assert [line.split("\t")[1] for line in text.splitlines()] == [
        "tile 1101", "tile 1102", "tile 2103"]
    rc, text, blobs = _run(lambda a: main(a, device="cpu"),
                           COMMANDS["merge"], files, out, capsys)
    merged = int(text.split("merged ")[1].split()[0])
    assert merged > 150 and blobs["m.fastq"].count(b"\n") == 4 * merged


def test_torch_device_option(files, tmp_path, capsys):
    argv = COMMANDS["trim_bwa"]
    a = _run(lambda x: main(["--torch-device", "cpu"] + x), argv, files,
             str(tmp_path / "a"), capsys)
    b = _run(lambda x: main(x, device="cpu"), argv, files,
             str(tmp_path / "b"), capsys)
    assert a == b and a[0] == 0
    assert main(["--torch-device"]) == 2
    assert main([]) == 2 and main(["nope"]) == 2


def test_cuda_default_refused_without_cuda(files):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for argv in (["trim", files["reads"]], ["stats",
                                                  files["reads"]],
                 ["--torch-device", "cuda", "tiles", files["reads"]]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(argv)
    # host-only commands need no card
    assert main(["count", files["reads"]]) == 0


def test_cli_and_scan_ops_load_no_jax(files, tmp_path):
    code = (
        "import sys\n"
        "import torch\n"
        "from blazeseq_tpu_torch.__main__ import main\n"
        "from blazeseq_tpu_torch.ops import scan, raw_stats\n"
        "for argv in (['stats', '--device', %(r)r], ['trim', '--out', %(t)r,"
        " %(r)r], ['demux', '--barcode', 'ACGTACGT', '--out', %(d)r, %(r)r],"
        " ['merge', %(r1)r, %(r2)r], ['tiles', %(r)r], ['count', %(r)r]):\n"
        "    assert main(['--torch-device', 'cpu'] + argv) == 0\n"
        "data = torch.from_numpy(__import__('numpy').fromfile(%(r)r,"
        " 'uint8'))\n"
        "n = int(scan.count_records_device(data))\n"
        "assert n == int(raw_stats.raw_stream_qc(data, 33, 126, 33).reads)\n"
        "assert int(scan.parse_fastq_device(data, 1024, 160)[3]) == n\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "print('ok', n)\n" % dict(r=files["reads"],
                                  t=str(tmp_path / "t.fq"),
                                  d=str(tmp_path / "dm"),
                                  r1=files["r1"],
                                  r2=files["r2"]))
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok 600"


def test_module_entry_point(files, tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-m", "blazeseq_tpu_torch", "--torch-device", "cpu",
         "count", files["reads"]], cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n, bases = bt.FastqParser(bt.open_reader(files["reads"])).count()
    assert out.stdout == "%s\t%d\t%d\n" % (files["reads"], n, bases)


@pytest.mark.parametrize("name", ["stats", "stats_device", "trim_window",
                                  "trim_bwa", "trim_ends", "demux", "merge",
                                  "tiles"])
def test_command_on_card_matches_cpu(name, files, tmp_path, capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    argv = COMMANDS[name]
    got = _run(lambda a: main(a, device="cuda"), argv, files,
               str(tmp_path / "cuda"), capsys)
    want = _run(lambda a: main(a, device="cpu"), argv, files,
                str(tmp_path / "cpu"), capsys)
    assert got == want and got[0] == 0
