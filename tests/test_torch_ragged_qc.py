"""Parity: the PyTorch port's ragged-layout QC step (ops/ragged_qc.py)
against blazeseq_tpu/ops/ragged_qc.py::ragged_qc on JAX CPU, on the corpora
of tests/test_ragged_qc.py.

`ok` and `tail_start` must agree on every case, and every QCStats leaf
where the reference gives `ok and not fallback` (np.array_equal). Every
chunk is padded to one size, so that the reference compiles once per set of
static arguments. Deliberate difference: where the reference reports
`fallback` (records far shorter than the width overflow its slots), the
port stays on the device; its stats are then held against the host engine
(the reference's FastqParser.padded_batches + qc_stats).

The CUDA kernels are held against the plain version on the card, on the
edge cases of chip_smoke.py's phase_kernel_ragged; those cases skip where
there is no CUDA device. A CUDA chunk never reaches the plain version, and
a kernel library that cannot load makes the call raise.
"""

import importlib
import importlib.util
import os

import numpy as np
import pytest
import torch

import blazeseq_tpu as bt
from blazeseq_tpu.fastq.quality import parse_schema
from blazeseq_tpu_torch import _kernels
from blazeseq_tpu_torch.ops.ragged_qc import ragged_qc, ragged_qc_torch

# the module (the package's `ragged_qc` attribute is the function)
rqc_mod = importlib.import_module("blazeseq_tpu_torch.ops.ragged_qc")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every chunk's padded size: a multiple of 2 * round_up(width, 128) for
# widths 128, 256, 384 and 1024
CHUNK = 3 << 15
LUT = np.array([2, 12, 23, 37])
EDGES = np.array([7, 18, 30])


def gen(n, lo, hi, seed=0, schema="sanger"):
    return bytes(bt.generate_variable_id_fastq_buffer(
        n, lo, hi, 2, 40, schema, seed=seed))


def _binned(buf):
    """`buf` with its qualities mapped onto the four NovaSeq bins."""
    a = np.frombuffer(buf, np.uint8).copy()
    nl = np.flatnonzero(a == 10)
    for s, e in zip(nl[2::4], nl[3::4]):
        q = a[s + 1:e].astype(np.int64) - 33
        a[s + 1:e] = LUT[np.searchsorted(EDGES, q)] + 33
    return a.tobytes()


def _mutate(buf, kind):
    b = bytearray(buf)
    if kind == "quality":
        b[-2] = 200  # the last quality byte: high bit and out of range
    elif kind == "newline":
        b[-2] = 10  # a premature newline inside the last quality line
    elif kind == "at":
        b[0] = ord("X")
    elif kind == "plus":
        b[b.index(b"\n+\n") + 1] = ord("-")
    elif kind == "ascii_id":
        b[3] |= 0x80
    return bytes(b)


def _len_mismatch():
    # seq lengths (90, 92), qual lengths (92, 90): the totals agree, so
    # only a per-record check sees it
    q = chr(parse_schema("sanger").OFFSET + 30).encode()
    return (b"@r1 x:1\n" + b"A" * 90 + b"\n+\n" + q * 92 + b"\n"
            + b"@r2 xx:22\n" + b"C" * 92 + b"\n+\n" + q * 90 + b"\n")


def _lower(buf):
    b = bytearray(buf)
    for i in range(b.index(b"\n") + 1, b.index(b"\n") + 40):
        b[i] |= 0x20  # lower-case the first read's bases
    return bytes(b)


def _case(name):
    """(bytes, n_valid, width, schema, checks on, hist_vals, len_vals)."""
    mixed = gen(300, 80, 120)
    if name == "mixed_w128":
        return mixed, None, 128, "sanger", True, (), ()
    if name == "mixed_w256":
        return mixed, None, 256, "sanger", True, (), ()
    if name == "uniform":
        return bytes(bt.generate_synthetic_fastq_buffer(
            250, 100, 100, 2, 40, "sanger")), None, 128, "sanger", True, (), ()
    if name == "illumina_lower":
        buf = _lower(gen(300, 90, 100, seed=3, schema="illumina_1.3"))
        return buf, None, 128, "illumina_1.3", True, (), ()
    if name == "checks_off":
        return gen(300, 64, 90, seed=5), None, 128, "sanger", False, (), ()
    if name == "partial_tail":
        buf = gen(100, 80, 100, seed=7)
        return buf[:len(buf) - 37], None, 128, "sanger", True, (), ()
    if name.startswith("bad_"):
        return (_mutate(gen(50, 80, 100, seed=9), name[4:]), None, 128,
                "sanger", True, (), ())
    if name == "len_mismatch":
        return _len_mismatch(), None, 128, "sanger", True, (), ()
    if name == "long_w128":
        return gen(50, 200, 300, seed=12), None, 128, "sanger", True, (), ()
    if name == "long_w384":
        return gen(50, 200, 300, seed=12), None, 384, "sanger", True, (), ()
    if name == "long_mixed_w256":
        buf = gen(40, 230, 260, seed=14) + gen(10, 700, 900, seed=15)
        return buf, None, 256, "sanger", True, (), ()
    if name == "multi_tile_lines":
        return gen(12, 900, 1600, seed=13), None, 128, "sanger", True, (), ()
    if name == "empty":
        return b"", None, 128, "sanger", True, (), ()
    if name == "padding_ignored":
        # a bad byte and a newline past n_valid are padding
        buf = gen(100, 80, 100, seed=8)
        return (buf + b"X\n\xff\n", len(buf), 128, "sanger", True, (), ())
    if name.startswith("eq_modes"):
        buf = bytearray(_binned(gen(300, 80, 89, seed=16)))
        if name.endswith("missed"):
            buf[buf.index(b"\n+\n") + 4] = 33 + 9  # a Phred outside the set
        # length 85 is missing from the set: it lands in the remainder bin
        lens = tuple(v for v in range(80, 90) if v != 85)
        return bytes(buf), None, 128, "sanger", True, (2, 12, 23, 37), lens
    raise KeyError(name)


CASES = ["mixed_w128", "mixed_w256", "uniform", "illumina_lower",
         "checks_off", "partial_tail", "bad_quality", "bad_newline", "bad_at",
         "bad_plus", "bad_ascii_id", "len_mismatch", "long_w128", "long_w384",
         "long_mixed_w256", "multi_tile_lines", "empty", "padding_ignored",
         "eq_modes", "eq_modes_missed"]
INVALID = {"bad_quality", "bad_newline", "bad_at", "bad_plus",
           "bad_ascii_id", "len_mismatch"}


def test_kernel_b_refused_layout_on_card(tmp_path):
    """Deliberate difference, on the card: 600 bp reads under a 1024-column
    window exceed kernel B's 512 stats columns, so the uniform file runs on
    the ragged tier (the reference keeps it on its uniform kernel); its
    report equals the CPU's, which runs it on the uniform tier."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from blazeseq_tpu_torch import QCModel

    p = str(tmp_path / "long.fastq")
    with open(p, "wb") as f:
        f.write(bytes(bt.generate_synthetic_fastq_buffer(
            3000, 600, 600, 2, 40, "sanger")))
    runs = {}
    for device in ("cuda", "cpu"):
        m = QCModel(quality_schema="sanger", max_read_len=1024, device=device)
        rep = m.run_file_device(p, chunk_mb=1)
        runs[device] = (rep, {k for k, v in m.tier_chunks.items() if v})
    assert runs["cuda"][1] == {"ragged"} and runs["cpu"][1] == {"uniform"}
    (a, _), (b, _) = runs["cuda"], runs["cpu"]
    assert a.to_dict() == b.to_dict()
    for k in ("base_counts", "qual_hist", "length_hist", "gc_hist",
              "mean_qual_hist", "per_pos_base_counts", "per_pos_count"):
        assert np.array_equal(getattr(a, k), getattr(b, k)), k


def _load_chip_smoke():
    """chip_smoke.py (numpy and the standard library at import), for the
    edge cases of its phase_kernel_ragged."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CHIP_SMOKE = _load_chip_smoke()


def _args(width, schema, check, hist_vals=(), len_vals=()):
    sch = parse_schema(schema)
    return dict(width=width, q_lo=int(sch.LOWER), q_hi=int(sch.UPPER),
                offset=int(sch.OFFSET), check_ascii=check,
                check_quality=check, hist_vals=hist_vals, len_vals=len_vals)


def _padded(buf):
    arr = np.zeros(CHUNK, np.uint8)
    arr[:len(buf)] = np.frombuffer(buf, np.uint8)
    return arr


def _reference(arr, n_valid, args):
    import jax.numpy as jnp
    from blazeseq_tpu.ops.ragged_qc import ragged_qc as ref_ragged_qc

    return ref_ragged_qc(jnp.asarray(arr), jnp.int32(n_valid), **args)


def _assert_stats_equal(want, got, label):
    for name, a, b in zip(want._fields, want, got):
        if a is None:
            assert b is None, (label, name)
            continue
        np.testing.assert_array_equal(np.asarray(a, np.int64),
                                      b.numpy().astype(np.int64),
                                      err_msg="%s: %s" % (label, name))


def _host_stats(buf, width, schema="sanger"):
    """The host engine's stats: the reference's parser and qc_stats."""
    import jax.numpy as jnp
    from blazeseq_tpu.ops.stats import QCAccumulator, qc_stats

    parser = bt.FastqParser(bt.MemoryReader(buf), config=bt.ParserConfig(
        check_ascii=True, check_quality=True, quality_schema=schema))
    acc = QCAccumulator()
    offset = int(parse_schema(schema).OFFSET)
    for pb in parser.padded_batches(1024, max_len=width, pad_records_to=1024):
        acc.add(qc_stats(jnp.asarray(pb.seq), jnp.asarray(pb.qual),
                         jnp.asarray(pb.lengths, dtype=jnp.int32),
                         jnp.int32(offset), n_records=jnp.int32(pb.n_records)))
    return acc.total


@pytest.mark.parametrize("name", CASES)
def test_matches_reference(name):
    buf, n_valid, width, schema, check, hv, lv = _case(name)
    n_valid = len(buf) if n_valid is None else n_valid
    args = _args(width, schema, check, hv, lv)
    arr = _padded(buf)
    want = _reference(arr, n_valid, args)
    got = ragged_qc_torch(torch.from_numpy(arr), n_valid, **args)
    assert not bool(want.fallback) and not bool(got.fallback)
    assert bool(got.ok) == bool(want.ok) == (name not in INVALID)
    assert int(got.tail_start) == int(want.tail_start)
    if bool(want.ok):
        _assert_stats_equal(want.stats, got.stats, name)
    # the dispatching wrapper on a CPU tensor, and the chunk read 2-D
    via = ragged_qc(torch.from_numpy(arr).view(-1, 2 * 128), n_valid, **args)
    for a, b in zip((got.ok, got.tail_start, *got.stats),
                    (via.ok, via.tail_start, *via.stats)):
        if a is not None:
            assert torch.equal(a, b)
    if name == "eq_modes_missed":
        assert int(got.stats.qual_hist[38]) == 1  # max(hist_vals) + 1
        assert int(got.stats.length_hist[90]) > 0  # the reads of length 85
    if name == "partial_tail":
        assert 0 < int(got.tail_start) < n_valid


def test_short_records_stay_on_device():
    """Deliberate difference: records far shorter than the width make the
    reference report `fallback` (its slot capacity, and records shorter
    than min(longest line, width)); the port keeps the chunk, and its
    stats equal the host engine's."""
    buf = gen(200, 10, 20, seed=11)
    args = _args(128, "sanger", True)
    arr = _padded(buf)
    assert bool(_reference(arr, len(buf), args).fallback)
    got = ragged_qc_torch(torch.from_numpy(arr), len(buf), **args)
    assert bool(got.ok) and not bool(got.fallback)
    assert int(got.tail_start) == len(buf)
    _assert_stats_equal(_host_stats(buf, 128), got.stats, "short records")


@pytest.mark.parametrize("label", ["w=128 clean", "w=1024 partial tail",
                                   "w=8192 clean",
                                   "view 1 byte off, odd length",
                                   "illumina_1.3 schema",
                                   "padding past n_valid", "tiny chunk",
                                   *CHIP_SMOKE.RAGGED_TILE_CASES])
def test_card_edge_cases_match_host_engine(label):
    """The plain version, which the card cases hold the kernels against,
    on edge cases of chip_smoke.py where the reference reports `fallback`
    (reads of 0 and 1 bases beside reads of 3 x width), and on its cases
    at the kernels' tile boundaries: its stats equal the host engine's
    over the complete records."""
    host, _, n_valid, kw = CHIP_SMOKE.ragged_edge_case(label, 0)
    got = ragged_qc_torch(torch.from_numpy(host), n_valid, **kw)
    assert bool(got.ok) and not bool(got.fallback)
    tail = int(got.tail_start)
    schema = "illumina_1.3" if kw["offset"] == 64 else "sanger"
    _assert_stats_equal(_host_stats(host[:tail].tobytes(), kw["width"],
                                    schema), got.stats, label)


def test_preconditions_raise():
    c = torch.zeros(512, dtype=torch.uint8)
    kw = _args(128, "sanger", True)
    with pytest.raises(ValueError, match="eq-mode"):
        ragged_qc(c, 512, **dict(kw, hist_vals=(2, 93)))
    with pytest.raises(ValueError, match="remainder bin"):
        ragged_qc(c, 512, **dict(kw, len_vals=(511,)))
    with pytest.raises(ValueError, match="outside the chunk"):
        ragged_qc(c, 513, **kw)
    with pytest.raises(TypeError, match="uint8"):
        ragged_qc(c.to(torch.int32), 512, **kw)
    with pytest.raises(ValueError, match="unsupported device"):
        ragged_qc(c.to("meta"), 512, **kw)


class _LooksCuda(torch.Tensor):
    """A CPU tensor that reports is_cuda, to reach the CUDA dispatch branch
    without a card."""

    @property
    def is_cuda(self):
        return True


def test_cuda_chunk_never_runs_the_plain_version(monkeypatch):
    """A CUDA chunk goes to the kernels or raises: with a kernel library
    that cannot load, the call raises, reaches no plain version and counts
    no launch."""
    def fail_to_load():
        raise RuntimeError("kernel library unavailable (test)")

    def plain_must_not_run(*a, **k):
        raise AssertionError("plain version reached from the CUDA branch")

    monkeypatch.setattr(_kernels, "load", fail_to_load)
    monkeypatch.setattr(rqc_mod, "_ragged_qc_raw_torch", plain_must_not_run)
    buf = gen(20, 30, 60)
    chunk = torch.Tensor._make_subclass(
        _LooksCuda, torch.from_numpy(_padded(buf)))
    before = ragged_qc.launches
    with pytest.raises(RuntimeError, match="kernel library unavailable"):
        ragged_qc(chunk, len(buf), **_args(128, "sanger", True))
    assert ragged_qc.launches == before


@pytest.mark.parametrize("label", CHIP_SMOKE.RAGGED_EDGE_CASES)
def test_kernel_matches_plain_on_card(label):
    """One edge case of chip_smoke.py's phase_kernel_ragged: the kernels
    against the plain version on the card, every output leaf exact, one
    launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    host, off, n_valid, kw = CHIP_SMOKE.ragged_edge_case(label, 0)
    dev = torch.zeros(len(host) + off, dtype=torch.uint8, device="cuda")
    dev[off:].copy_(torch.from_numpy(host))
    c = dev[off:]
    before = ragged_qc.launches
    got = ragged_qc(c, n_valid, **kw)
    want = ragged_qc_torch(c, n_valid, **kw)
    torch.cuda.synchronize()
    assert ragged_qc.launches == before + 1
    for a, b in zip((got.ok, got.fallback, got.tail_start, *got.stats),
                    (want.ok, want.fallback, want.tail_start, *want.stats)):
        if a is not None:
            assert torch.equal(a, b), label
