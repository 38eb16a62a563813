"""Parity: the PyTorch port's raw_stream_qc against
blazeseq_tpu/ops/raw_stats.py.

Every leaf of RawStreamQC (reads, bases, base_counts, the 64-bin Phred
histogram, the four flags and tail_start) must equal the reference's on the
same bytes (np.array_equal), on the reference tests' cases, on flag
violations, on chunks that start or end mid-record, and on 64 KiB chunks of
random FASTQ, and on every case of chip_smoke.py's
DEVICE_PARSE_EDGE_CASES. CPU tensors reach the plain raw_stream_qc_torch; a
CUDA path whose kernels cannot load raises. Cases named *on_card* hold the
kernel against the plain version with the chunk on a CUDA card and skip
where there is none.
"""

import collections
import importlib.util
import os

import numpy as np
import pytest
import torch

import blazeseq_tpu as bt
from blazeseq_tpu_torch import _kernels
from blazeseq_tpu_torch.ops import raw_stats
from blazeseq_tpu_torch.ops.raw_stats import (RawStreamQC, raw_stream_qc,
                                              raw_stream_qc_torch)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_chip_smoke():
    """chip_smoke.py (numpy and the standard library at import), for the
    edge cases of its phase_kernel_device_parse."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CHIP_SMOKE = _load_chip_smoke()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel worker processes: keep this module's
    torch CPU ops on one thread so they do not crowd the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref(data, lower=33, upper=126, offset=33, max_phred=64):
    pytest.importorskip("blazeseq_tpu.ops.raw_stats")
    import jax.numpy as jnp

    from blazeseq_tpu.ops.raw_stats import raw_stream_qc as ref_qc

    return ref_qc(jnp.asarray(np.frombuffer(data, np.uint8)),
                  jnp.int32(lower), jnp.int32(upper), jnp.int32(offset),
                  max_phred=max_phred)


def _port(data, lower=33, upper=126, offset=33, device="cpu"):
    chunk = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
    return raw_stream_qc(chunk.to(device), lower, upper, offset)


def _assert_equal(port, ref):
    for name, p, r in zip(RawStreamQC._fields, port, ref):
        r = np.asarray(r)
        p = p.cpu().numpy()
        assert p.shape == r.shape and p.dtype == r.dtype, name
        np.testing.assert_array_equal(p, r, err_msg=name)


def _golden(buf: bytes):
    reads = bases = qsum = 0
    comp = collections.Counter()
    for v in bt.FastqParser(bt.MemoryReader(buf)).views():
        reads += 1
        s = bytes(v.sequence_bytes())
        bases += len(s)
        for ch in s.upper():
            comp[chr(ch) if chr(ch) in "ACGT" else "other"] += 1
        for qb in bytes(v.quality_bytes()):
            qsum += max(0, min(qb - 33, 63))
    return reads, bases, comp, qsum


CASES = {
    "uniform": lambda: bytes(bt.generate_synthetic_fastq_buffer(
        300, 80, 80, 2, 40, "sanger")),
    "mixed": lambda: bytes(bt.generate_synthetic_fastq_buffer(
        300, 20, 200, 2, 40, "sanger")),
    "dos": lambda: b"@a\r\nACGT\r\n+\r\nIIII\r\n@b\r\nGG\r\n+\r\nII\r\n",
    "tail": lambda: b"@a\nACGT\n+\nIIII\n@b\nGG\n+",
}


@pytest.mark.parametrize("kind", sorted(CASES))
def test_matches_reference_and_host(kind):
    buf = CASES[kind]()
    got = _port(buf)
    _assert_equal(got, _ref(buf))
    complete = buf[: buf.rindex(b"@b")] if kind == "tail" else buf
    reads, bases, comp, qsum = _golden(complete)
    assert int(got.reads) == reads and int(got.bases) == bases
    assert got.base_counts.tolist() == [comp[c] for c in "ACGT"] + [
        comp["other"]]
    assert got.mean_q_sum() == qsum
    assert int(got.tail_start) == len(complete)
    assert bool(got.bad_quality) == (kind == "dos")


FLAG_CASES = [
    (b"@a\nAC\n+\nII\n", {}, ()),
    (b"Xa\nAC\n+\nII\n", {}, ("bad_structure",)),
    (b"@a\nAC\nx\nII\n", {}, ("bad_structure",)),
    # 0xff is above the quality range as well
    (b"@a\nAC\xff\n+\nII\xff\n", {}, ("bad_ascii", "bad_quality")),
    (b"@a\nAC\n+\n I\n", dict(lower=35), ("bad_quality",)),
    (b"@a\nACG\n+\nII\n", {}, ("seq_qual_mismatch",)),
    (b"@a\nAC\n+\nI\x10\n", dict(lower=0, offset=64), ()),
]


@pytest.mark.parametrize("buf,kw,flags", FLAG_CASES)
def test_flags_match_reference(buf, kw, flags):
    got = _port(buf, **kw)
    _assert_equal(got, _ref(buf, **kw))
    for f in ("bad_structure", "bad_ascii", "bad_quality",
              "seq_qual_mismatch"):
        assert bool(getattr(got, f)) == (f in flags), f
        assert getattr(got, f).dim() == 0
        assert getattr(got, f).dtype == torch.bool


def _random_chunk(seed, size=1 << 16):
    """A 64 KiB window of random FASTQ that starts at a record boundary and
    ends mid-record, with lower-case, N and high-quality bytes."""
    rng = np.random.default_rng(seed)
    recs = []
    total = 0
    while total < size + 600:
        n = int(rng.integers(0, 250))
        seq = rng.choice(np.frombuffer(b"ACGTNacgtn", np.uint8), n)
        qual = rng.integers(33, 110, n).astype(np.uint8)
        rec = (b"@r%d xyz\n" % len(recs) + seq.tobytes() + b"\n+\n"
               + qual.tobytes() + b"\n")
        recs.append(rec)
        total += len(rec)
    return b"".join(recs)[:size]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_chunks_match_reference(seed):
    buf = _random_chunk(seed)
    got = _port(buf, upper=104)
    _assert_equal(got, _ref(buf, upper=104))
    assert 0 < int(got.tail_start) < len(buf)
    assert bool(got.bad_quality)  # bytes up to 109 exceed upper=104


def test_mean_q_sum_no_overflow():
    hist = torch.zeros(64, dtype=torch.int32)
    hist[40] = 2_000_000_000
    z = torch.zeros((), dtype=torch.int32)
    f = torch.zeros((), dtype=torch.bool)
    qc = RawStreamQC(z, z, torch.zeros(5, dtype=torch.int32), hist, f, f, f,
                     f, z)
    assert qc.mean_q_sum() == 40 * 2_000_000_000


def test_empty_chunk_returns_zero_stats():
    got = _port(b"")
    _assert_equal(got, _ref(b""))
    assert int(got.reads) == 0 and int(got.tail_start) == 0
    assert got.qual_hist.shape == (64,)


@pytest.mark.parametrize("seed", [0, 5])
def test_random_chunks_on_card_match_cpu(seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    buf = _random_chunk(seed)
    for a, b in zip(_port(buf, device="cuda"), _port(buf)):
        assert torch.equal(a.cpu(), b)


def _edge(label, device="cpu"):
    """An edge case's chunk (a view `off` bytes into its storage) and
    raw_stream_qc's quality arguments."""
    case = CHIP_SMOKE.device_parse_edge_case(label, 0)
    off = case["off"]
    host = np.concatenate([np.zeros(off, np.uint8), case["data"]])
    chunk = torch.from_numpy(host).to(device)[off:]
    args = tuple(case[k] for k in ("q_lower", "q_upper", "offset",
                                   "max_phred"))
    return case, chunk, args


@pytest.mark.parametrize("label", CHIP_SMOKE.DEVICE_PARSE_EDGE_CASES)
def test_edge_cases_match_reference(label):
    case, chunk, args = _edge(label)
    got = raw_stream_qc(chunk, *args)
    _assert_equal(got, _ref(case["data"].tobytes(), *args))
    assert got.qual_hist.shape == (case["max_phred"],)


def test_edge_case_flags():
    """The flags the edge cases are built for: a high bit counts anywhere,
    a bad quality byte only in a complete record."""
    for label, want in (("high bit in the partial tail", "bad_ascii"),
                        ("quality out of range in the partial tail", None),
                        ("missing '@'", "bad_structure"),
                        ("quality bounds 289/382", "bad_quality"),
                        ("fewer than 4 newlines", None)):
        _, chunk, args = _edge(label)
        got = raw_stream_qc(chunk, *args)
        for f in ("bad_structure", "seq_qual_mismatch", "bad_ascii",
                  "bad_quality"):
            assert bool(getattr(got, f)) == (f == want), (label, f)
    _, chunk, args = _edge("fewer than 4 newlines")
    assert int(raw_stream_qc(chunk, *args).tail_start) == 0


def test_dispatch_cpu_takes_the_plain_version(monkeypatch):
    reached = []

    def spy(*a, **k):
        reached.append(1)
        return raw_stream_qc_torch(*a, **k)

    monkeypatch.setattr(raw_stats, "raw_stream_qc_torch", spy)
    before = raw_stream_qc.launches
    _, chunk, args = _edge("CRLF file")
    got = raw_stream_qc(chunk, *args)
    assert reached == [1] and raw_stream_qc.launches == before
    _assert_equal(got, raw_stream_qc_torch(chunk, *args))


class _LooksCuda(torch.Tensor):
    """A CPU tensor that reports is_cuda, to reach the CUDA dispatch branch
    without a card."""

    @property
    def is_cuda(self):
        return True


def test_cuda_dispatch_raises_when_kernels_cannot_load(monkeypatch):
    def fail():
        raise RuntimeError("kernel library unavailable (test)")

    def twin_must_not_run(*a, **k):
        raise AssertionError("plain version reached from the CUDA branch")

    monkeypatch.setattr(_kernels, "load", fail)
    monkeypatch.setattr(raw_stats, "raw_stream_qc_torch", twin_must_not_run)
    before = raw_stream_qc.launches
    chunk = torch.Tensor._make_subclass(_LooksCuda, torch.from_numpy(
        np.frombuffer(b"@a\nAC\n+\nII\n" * 9, np.uint8).copy()))
    with pytest.raises(RuntimeError, match="kernel library unavailable"):
        raw_stream_qc(chunk, 33, 126, 33)
    assert raw_stream_qc.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        raw_stream_qc(torch.zeros(4, dtype=torch.uint8, device="meta"), 33,
                      126, 33)


@pytest.mark.parametrize("label", CHIP_SMOKE.DEVICE_PARSE_EDGE_CASES)
def test_edge_cases_kernel_matches_plain_on_card(label):
    """The kernel against the plain version on the card, every leaf exact,
    one launch counted (none for an empty chunk, which launches nothing)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    _, chunk, args = _edge(label, "cuda")
    before = raw_stream_qc.launches
    got = raw_stream_qc(chunk, *args)
    want = raw_stream_qc_torch(chunk, *args)
    torch.cuda.synchronize()
    assert raw_stream_qc.launches == before + (chunk.numel() > 0)
    for name, a, b in zip(RawStreamQC._fields, got, want):
        assert a.is_cuda and a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), name


@pytest.mark.parametrize("off", CHIP_SMOKE.MANY_TILE_OFFSETS)
@pytest.mark.parametrize("label", CHIP_SMOKE.MANY_TILE_CASES)
def test_many_tiles_kernel_matches_plain_on_card(label, off):
    """1,024 tiles and more (the persistent grid's lanes meet the quality
    line of one value in more tiles than their 8-bit counters hold), at
    views off 16-byte alignment, run MANY_TILE_RUNS times: every leaf equal
    to the plain version's each time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    data = CHIP_SMOKE.device_parse_many_tiles(label, 0)
    dev = torch.zeros(len(data) + off, dtype=torch.uint8, device="cuda")
    dev[off:].copy_(torch.from_numpy(data))
    chunk = dev[off:]
    want = raw_stream_qc_torch(chunk, 33, 126, 33)
    for _ in range(CHIP_SMOKE.MANY_TILE_RUNS):
        got = raw_stream_qc(chunk, 33, 126, 33)
        torch.cuda.synchronize()
        for name, a, b in zip(RawStreamQC._fields, got, want):
            assert torch.equal(a, b), name
