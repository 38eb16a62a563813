"""The benchmark's files: every name in BENCHMARK.json leads to its file,
and nothing under bench_port/ imports JAX, the JAX package, or (in the
references and generators) the port.

    python -m pytest bench_port -q
"""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

from bench_port import harness  # noqa: E402

BENCH = harness.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def _py_files(sub=""):
    base = os.path.join(HERE, sub)
    for d, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _top_imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_py_files()),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax_import(path):
    # whole top-level names: the port's name begins with the JAX package's
    assert not set(_top_imports(path)) & set(harness.BARRED)


@pytest.mark.parametrize("sub", ["reference", "gen", "roofline"])
def test_yardstick_imports_nothing_of_the_port(sub):
    for path in _py_files(sub):
        assert "blazeseq_tpu_torch" not in set(_top_imports(path)), path


def test_benchmark_json_contract():
    assert BENCH["command"] == ["python3", "bench_port/run.py"]
    assert BENCH["paths"] == ["bench_port"]
    assert 1 <= BENCH["run_seconds"] <= 51
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        for w in m["workloads"]:
            mv = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
            assert w in mv.get("workloads", CELLS)
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        per = [m for m in BENCH["end_to_end"]
               if w["name"] in m.get("workloads", CELLS)]
        assert len(per) >= 2
        assert any(w["name"] in m["workloads"] for m in BENCH["per_layer"])
    assert len(json.dumps(BENCH)) < 64 << 10


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"]])
def test_end_to_end_metric_has_a_reader(metric):
    assert callable(harness.load_module("end_to_end", metric).read)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_per_layer_metric_has_a_reader(metric):
    assert callable(harness.load_module("metrics", metric).read)


@pytest.mark.parametrize("path", sorted(
    os.path.join(kind, f) for kind in ("end_to_end", "metrics")
    for f in os.listdir(os.path.join(HERE, kind))
    if f.endswith(".py") and not f.startswith("_")))
def test_every_reader_file_loads(path):
    kind, name = os.path.split(path)
    assert callable(harness.load_module(kind, name[:-len(".py")]).read)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    w = harness.load_json("workloads", cell + ".json")
    assert {k: w[k] for k in ("config", "traffic", "chips", "why")} == {
        k: entry[k] for k in ("config", "traffic", "chips", "why")}
    c = harness.Cell.load(cell)
    assert c.config["name"] == entry["config"]
    harness.load_module("gen", c.config["name"])
    harness.load_module("routes", c.route)
    harness.load_module("reference", c.route)


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    path = os.path.join(ROOT, cfg["file"])
    assert path.startswith(os.path.join(ROOT, "bench_port") + os.sep)
    c = json.load(open(path))
    assert c["name"] == cfg["name"] and c["source"] == cfg["source"]
    assert c["reduced"] == cfg["reduced"]
    assert all(k in c for k in cfg["reduced"])


def test_command_without_a_card_prints_no_result(tmp_path):
    if _has_card():
        pytest.skip("a CUDA card is present: the command would measure")
    r = subprocess.run([sys.executable, "bench_port/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""


def _has_card() -> bool:
    import torch

    return torch.cuda.is_available()
