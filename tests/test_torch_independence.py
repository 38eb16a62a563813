"""The port stands alone: no module of blazeseq_tpu_torch, and not
chip_smoke.py, imports the reference package or JAX, and a fresh
interpreter that drives the port's entry points on the CPU (QCModel,
NWAligner and the command line with count, stats and fqidx) ends with
neither in sys.modules.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO, "blazeseq_tpu_torch")
FORBIDDEN = ("blazeseq_tpu", "jax", "jaxlib")


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PACKAGE):
        out += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    """(line, absolute module name) of every import in a source file;
    relative imports stay inside their own package and are skipped."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def test_no_port_module_imports_the_reference_or_jax():
    sources = _port_sources()
    assert len(sources) > 40
    bad = ["%s:%d imports %s" % (os.path.relpath(p, REPO), line, name)
           for p in sources for line, name in _imported_roots(p)
           if name.split(".")[0] in FORBIDDEN]
    assert bad == []


def test_the_scan_sees_a_forbidden_import(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import os\nfrom . import x\nfrom blazeseq_tpu.io import "
                   "readers\ndef f():\n    import jax.numpy as jnp\n")
    assert [n for _, n in _imported_roots(str(src))
            if n.split(".")[0] in FORBIDDEN] == ["blazeseq_tpu.io", "jax.numpy"]


def test_entry_points_load_neither_the_reference_nor_jax(tmp_path):
    rng = np.random.default_rng(0)
    recs = []
    for i in range(300):
        ln = int(rng.integers(20, 120))
        seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), ln).tobytes()
        q = rng.integers(35, 74, ln).astype(np.uint8).tobytes()
        recs.append(b"@r%d\n%s\n+\n%s\n" % (i, seq, q))
    reads = tmp_path / "reads.fastq"
    reads.write_bytes(b"".join(recs))
    code = (
        "import sys\n"
        "from blazeseq_tpu_torch import NWAligner, QCModel, FastqParser, "
        "MemoryReader\n"
        "from blazeseq_tpu_torch.__main__ import main\n"
        "r = %(r)r\n"
        "rep = QCModel(quality_schema='sanger', align_to=b'GATTACA', "
        "device='cpu').run_file(r)\n"
        "assert rep.reads == 300, rep.reads\n"
        "dev = QCModel(quality_schema='sanger', device='cpu')"
        ".run_file_device(r, chunk_mb=1)\n"
        "assert dev.reads == 300\n"
        "batch = FastqParser(MemoryReader(open(r, 'rb').read()))"
        ".next_batch(50)\n"
        "assert NWAligner(b'GATTACA', device='cpu').verify_batch(batch)\n"
        "for argv in (['count', r], ['stats', r], ['fqidx', r]):\n"
        "    assert main(['--torch-device', 'cpu'] + argv) == 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('blazeseq_tpu', 'jax', 'jaxlib'))\n"
        "assert not bad, bad\n"
        "print('independent')\n" % dict(r=str(reads)))
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "independent"
    assert (tmp_path / "reads.fastq.fqi").exists()


@pytest.mark.parametrize("argv", [["count"], ["fqidx"], ["stats"]])
def test_module_entry_point_runs_alone(argv, tmp_path):
    """python -m blazeseq_tpu_torch in a fresh interpreter, from outside the
    repository, with the reference package hidden from the import path."""
    reads = tmp_path / "r.fastq"
    reads.write_bytes(b"@a\nACGT\n+\nIIII\n@b\nGG\n+\nII\n")
    blocker = tmp_path / "block"
    blocker.mkdir()
    for name in FORBIDDEN:
        # a module of the forbidden name that fails on import shadows the
        # real one, so any import of it would end the run
        (blocker / (name + ".py")).write_text(
            "raise ImportError('%s must not be imported')\n" % name)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(blocker), REPO]))
    out = subprocess.run(
        [sys.executable, "-m", "blazeseq_tpu_torch", "--torch-device", "cpu"]
        + argv + [str(reads)], cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout
