"""Parity: the PyTorch port's device-parse ops against
blazeseq_tpu/ops/scan.py.

structural_bitmaps_torch is held against the Pallas kernel
structural_bitmaps (interpret mode on the CPU, as tests/test_ops.py runs
it): the port's int32 bitmaps, viewed as uint32, must equal the reference's
uint32 words, and the row counts must be equal. count_records_device,
newline_positions_device, record_offsets_device, gather_padded_device and
parse_fastq_device are compared leaf by leaf (np.array_equal) with the
reference on the same bytes, including the uncapped record count, `start`,
structure codes and lengths past max_len. The CUDA kernel is held against
the plain version on the card; those cases skip where there is no card.
"""

import numpy as np
import pytest
import torch

import blazeseq_tpu as bt
from blazeseq_tpu_torch import _kernels
from blazeseq_tpu_torch.ops import scan


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel worker processes: keep this module's
    torch CPU ops on one thread so they do not crowd the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref():
    """The reference scan module, imported per test (it loads jax)."""
    return pytest.importorskip("blazeseq_tpu.ops.scan")


def _t(b):
    return torch.from_numpy(np.frombuffer(bytes(b), np.uint8).copy())


def _eq(port, ref):
    """Leaf-by-leaf equality of a port output (tensors) and a reference
    output (jax arrays)."""
    if not isinstance(port, (tuple, list)):
        port, ref = (port,), (ref,)
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        r = np.asarray(r)
        p = p.cpu().numpy()
        assert p.shape == r.shape, (p.shape, r.shape)
        if r.dtype == np.uint32:
            p = p.view(np.uint32)
        else:
            assert p.dtype == r.dtype, (p.dtype, r.dtype)
        np.testing.assert_array_equal(p, r)


def _mixed_fastq(n, seed=0):
    return bytes(bt.generate_synthetic_fastq_buffer(n, 5, 60, 2, 40,
                                                    "sanger"))


def _structural_soup(n, seed):
    """Bytes drawn from {'\\n', '@', '+', 'A'}: dense hits, every bit
    pattern."""
    rng = np.random.default_rng(seed)
    return rng.choice(np.frombuffer(b"\n@+A", np.uint8), n).tobytes()


BITMAP_INPUTS = {
    "records": lambda: b"@r1\nACGT\n+\nIIII\n" * 8,
    "mixed_fastq": lambda: _mixed_fastq(200),
    "soup": lambda: _structural_soup(1 << 14, 1),
    "all_bytes": lambda: np.random.default_rng(2).integers(
        0, 256, 1 << 13, dtype=np.uint8).tobytes(),
    "all_newlines": lambda: b"\n" * 256,
}


@pytest.mark.parametrize("name", sorted(BITMAP_INPUTS))
def test_bitmaps_match_pallas_kernel(name):
    ref = _ref()
    data = BITMAP_INPUTS[name]()
    arr = np.frombuffer(data, np.uint8)
    want = ref.structural_bitmaps(ref._pad_lane(arr))
    got = scan.structural_bitmaps_torch(scan._pad_lane(_t(data)))
    _eq(got, want)
    assert int(got[3].sum()) == data.count(b"\n")
    assert got[0].dtype == torch.int32 and got[3].shape[1] == 1


def test_bitmap_bit_layout():
    """Bit b of word w marks byte 32w + b of the row, the top bit
    included."""
    data = bytearray(b"A" * 256)
    for pos in (0, 31, 32, 95, 127, 128 + 63):
        data[pos] = 10
    data[5] = ord("@")
    data[127] = ord("+")
    nl, at, plus, counts = scan.structural_bitmaps_torch(_t(data))
    nl = nl.numpy().view(np.uint32)
    assert nl[0].tolist() == [(1 << 0) | (1 << 31), 1, 1 << 31, 0]
    assert nl[1].tolist() == [0, 1 << 31, 0, 0]
    assert at.numpy().view(np.uint32)[0].tolist() == [1 << 5, 0, 0, 0]
    assert plus.numpy().view(np.uint32)[0].tolist() == [0, 0, 0, 1 << 31]
    assert counts[:, 0].tolist() == [4, 1]


def test_bitmaps_refuse_bad_input():
    with pytest.raises(ValueError, match="multiple of 128"):
        scan.structural_bitmaps(torch.zeros(100, dtype=torch.uint8))
    with pytest.raises(ValueError, match=r"u8\[N\]"):
        scan.structural_bitmaps(torch.zeros(128, dtype=torch.int32))
    with pytest.raises(ValueError, match="unsupported device"):
        scan.structural_bitmaps(torch.zeros(128, dtype=torch.uint8,
                                            device="meta"))


def test_dispatch_cpu_takes_the_plain_version():
    data = _t(_structural_soup(4096, 3))
    before = scan.structural_bitmaps.launches
    got = scan.structural_bitmaps(data)
    want = scan.structural_bitmaps_torch(data)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert scan.structural_bitmaps.launches == before


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
    monkeypatch.setattr(scan, "structural_bitmaps_torch", twin_must_not_run)
    before = scan.structural_bitmaps.launches
    chunk = torch.Tensor._make_subclass(_LooksCuda, _t(b"@\n+A" * 64))
    with pytest.raises(RuntimeError, match="kernel library unavailable"):
        scan.structural_bitmaps(chunk)
    with pytest.raises(RuntimeError, match="kernel library unavailable"):
        scan.count_records_device(chunk)
    assert scan.structural_bitmaps.launches == before


@pytest.mark.parametrize("n", [0, 1, 127, 128, 129, 128 * 40 + 5])
def test_count_records_matches_reference(n):
    ref = _ref()
    data = (_mixed_fastq(400) * 2)[:n] if n > 1 else b"\n" * n
    want = ref.count_records_device(np.frombuffer(data, np.uint8)) \
        if n else None
    got = scan.count_records_device(_t(data))
    assert got.dim() == 0 and got.dtype == torch.int32
    assert int(got) == data.count(b"\n") // 4
    if want is not None:
        _eq(got, want)


@pytest.mark.parametrize("max_count", [4, 16, 64])
def test_newline_positions_match_reference(max_count):
    """Positions padded with n; the count is NOT capped at max_count."""
    ref = _ref()
    data = b"@r\nAC\n+\nII\n@r2\nACGT\n+\nIIII\n" * 2
    want = ref.newline_positions_device(np.frombuffer(data, np.uint8),
                                        max_count=max_count)
    got = scan.newline_positions_device(_t(data), max_count)
    _eq(got, want)
    assert int(got[1]) == data.count(b"\n") == 16


RECORD_INPUTS = {
    "clean": lambda: _mixed_fastq(20),
    "errors": lambda: (b"@r1\nACGT\n+\nIIII\nX2\nGG\n+\nII\n@r3\nAC\n+\nIIII"
                       b"\n@r4\nAC\n-\nII\n@r5\nACG\nx\nII\n"),
    "tail": lambda: _mixed_fastq(12) + b"@partial\nACGT\n+",
}


@pytest.mark.parametrize("max_records", [8, 32])
@pytest.mark.parametrize("name", sorted(RECORD_INPUTS))
def test_record_offsets_match_reference(name, max_records):
    ref = _ref()
    data = RECORD_INPUTS[name]()
    want = ref.record_offsets_device(np.frombuffer(data, np.uint8),
                                     max_records=max_records)
    got = scan.record_offsets_device(_t(data), max_records)
    _eq(got, want)


def test_record_count_is_not_capped():
    """20 records into 8 rows: n_records reports 20, every row is a real
    record."""
    ref = _ref()
    data = _mixed_fastq(20)
    offsets, n_rec, codes = scan.record_offsets_device(_t(data), 8)
    assert int(n_rec) == 20
    assert (offsets[:, 0] >= 0).all()
    _eq((offsets, n_rec, codes),
        ref.record_offsets_device(np.frombuffer(data, np.uint8),
                                  max_records=8))


def test_record_offsets_start():
    """Newlines before `start` are ignored; record 0's header is start."""
    ref = _ref()
    import jax.numpy as jnp

    junk = b"garbage\nmore\n"
    data = junk + _mixed_fastq(10)
    got = scan.record_offsets_device(_t(data), 16, start=len(junk))
    want = ref.record_offsets_device(np.frombuffer(data, np.uint8),
                                     max_records=16,
                                     start=jnp.int32(len(junk)))
    _eq(got, want)
    assert int(got[1]) == 10 and int(got[0][0, 0]) == len(junk)
    assert int(got[2].sum()) == 0


def test_record_offsets_match_native_scanner():
    from blazeseq_tpu import native

    data = _mixed_fastq(20)
    offsets, n_rec, codes = scan.record_offsets_device(_t(data), 32)
    assert int(n_rec) == 20 and int(codes.sum()) == 0
    host = native.scan_fastq(np.frombuffer(data, np.uint8))
    np.testing.assert_array_equal(offsets[:20].numpy(), host.offsets)


@pytest.mark.parametrize("max_len", [8, 32, 64])
def test_gather_padded_matches_reference(max_len):
    """Rows cut at max_len; lengths stay the true ones."""
    ref = _ref()
    data = _mixed_fastq(10)
    arr = np.frombuffer(data, np.uint8)
    offsets, _, _ = ref.record_offsets_device(arr, max_records=16)
    want = ref.gather_padded_device(arr, offsets, 16, max_len)
    got = scan.gather_padded_device(
        _t(data), torch.from_numpy(np.array(offsets)), 16, max_len)
    _eq(got, want)
    lengths = got[2].numpy()
    host = [len(r) for r in bt.FastqParser(bt.MemoryReader(data)).records()]
    assert lengths[:10].tolist() == host and (lengths[10:] == 0).all()


def test_parse_fastq_matches_reference_and_host():
    ref = _ref()
    data = _mixed_fastq(15)
    want = ref.parse_fastq_device(np.frombuffer(data, np.uint8),
                                  max_records=16, max_len=64)
    got = scan.parse_fastq_device(_t(data), 16, 64)
    _eq(got, want)
    seq, qual, lengths, n_rec, codes = got
    assert int(n_rec) == 15 and int(codes.sum()) == 0
    for i, r in enumerate(bt.FastqParser(bt.MemoryReader(data)).records()):
        L = int(lengths[i])
        assert L == len(r)
        assert seq[i, :L].numpy().tobytes() == r.sequence_bytes()
        assert qual[i, :L].numpy().tobytes() == r.quality_bytes()


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.parametrize("name", sorted(BITMAP_INPUTS))
def test_bitmaps_kernel_matches_plain_on_card(name):
    _needs_card()
    data = BITMAP_INPUTS[name]()
    chunk = scan._pad_lane(_t(data)).cuda()
    before = scan.structural_bitmaps.launches
    got = scan.structural_bitmaps(chunk)
    want = scan.structural_bitmaps_torch(chunk)
    torch.cuda.synchronize()
    assert scan.structural_bitmaps.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("n", [1, 127, 129, 128 * 1024 + 5])
def test_count_records_on_card(n):
    _needs_card()
    data = (_mixed_fastq(3000) * 2)[:n]
    got = scan.count_records_device(_t(data).cuda())
    assert got.is_cuda and got.dtype == torch.int32
    assert int(got) == data.count(b"\n") // 4


def test_parse_fastq_on_card_matches_cpu():
    _needs_card()
    data = _mixed_fastq(300) + b"@tail\nAC"
    cpu = scan.parse_fastq_device(_t(data), 512, 64)
    gpu = scan.parse_fastq_device(_t(data).cuda(), 512, 64)
    for c, g in zip(cpu, gpu):
        assert torch.equal(c, g.cpu())
