"""The port's kernel build (blazeseq_tpu_torch/_kernels.py) with a stand-in
nvcc: one compile per source, all running at once, then one link of every
object into the library; a failing compile raises with the compiler's
message and leaves no library behind. The real nvcc runs only on a machine
with the CUDA toolkit (chip_smoke.py builds there from a clean tree).
"""

import json
import os
import stat
import sys
import textwrap

import pytest

from blazeseq_tpu_torch import _kernels

FAKE_NVCC = textwrap.dedent("""\
    #!{python}
    import json, os, sys, time
    args = sys.argv[1:]
    out = args[args.index("-o") + 1]
    log = os.environ["FAKE_NVCC_LOG"]
    with open(log, "a") as f:
        f.write(json.dumps(["start", "-c" in args, time.time()]) + "\\n")
    if "-c" in args and os.path.basename(args[-1]) == os.environ.get(
            "FAKE_NVCC_FAIL"):
        sys.stderr.write("error: stand-in failure\\n")
        sys.exit(2)
    time.sleep(1.0 if "-c" in args else 0)
    with open(out, "w") as f:
        f.write(" ".join(args))
    with open(log, "a") as f:
        f.write(json.dumps(["end", "-c" in args, time.time()]) + "\\n")
    """)


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    log = tmp_path / "nvcc.log"
    monkeypatch.setenv("PATH", str(bin_dir) + os.pathsep
                       + os.environ.get("PATH", ""))
    monkeypatch.setenv("FAKE_NVCC_LOG", str(log))
    monkeypatch.setattr(_kernels, "BUILD_DIR", str(tmp_path / "build"))
    return log


def _events(log):
    return [json.loads(line) for line in log.read_text().splitlines()]


def test_sources_compile_together_then_link(fake_nvcc):
    lib = _kernels.build()
    assert os.path.exists(lib)
    with open(lib) as f:
        link = f.read().split()
    assert "-shared" in link
    assert sorted(os.path.basename(a) for a in link if a.endswith(".o")) \
        == sorted(s + ".o" for s in _kernels.SOURCES)
    ev = _events(fake_nvcc)
    compiles = [e for e in ev if e[1]]
    assert len(compiles) == 2 * len(_kernels.SOURCES)
    # every compile started before the first one ended
    first_end = min(t for kind, _, t in compiles if kind == "end")
    assert all(t < first_end for kind, _, t in compiles if kind == "start")
    # the link came last, and a second build reuses the library
    assert ev[-1][:2] == ["end", False]
    assert _kernels.build() == lib
    assert len(_events(fake_nvcc)) == len(ev)
    # only the library is left in the build directory
    out_dir = os.path.dirname(lib)
    assert os.listdir(out_dir) == [_kernels.LIB_NAME]


def test_every_kernel_source_is_built_and_bound():
    assert _kernels.SOURCES == ("validate.cu", "uniform_qc.cu", "nw.cu",
                                "scan.cu")
    for name in _kernels.SOURCES:
        assert os.path.exists(os.path.join(_kernels.CSRC, name))
    # one C entry point per kernel source, each with its argument types
    entries = {"validate.cu": "bs_validate_decode",
               "uniform_qc.cu": "bs_uniform_qc", "nw.cu": "bs_nw_scores",
               "scan.cu": "bs_structural_bitmaps"}
    for source, entry in entries.items():
        assert entry in _kernels._SIGNATURES
        with open(os.path.join(_kernels.CSRC, source)) as f:
            assert 'extern "C" int %s(' % entry in f.read()


def test_failed_compile_raises_and_leaves_no_library(fake_nvcc,
                                                     monkeypatch):
    for failing in _kernels.SOURCES:
        monkeypatch.setenv("FAKE_NVCC_FAIL", failing)
        with pytest.raises(RuntimeError, match="stand-in failure"):
            _kernels.build()
        out_dir = os.path.join(_kernels.BUILD_DIR, _kernels._source_hash())
        assert os.listdir(out_dir) == []
    # no link was attempted
    assert all(e[1] for e in _events(fake_nvcc))
