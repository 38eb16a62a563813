"""Parity: the PyTorch port's device-parse ops against
blazeseq_tpu/ops/scan.py.

structural_bitmaps_torch is held against the Pallas kernel
structural_bitmaps (interpret mode on the CPU, as tests/test_ops.py runs
it): the port's int32 bitmaps, viewed as uint32, must equal the reference's
uint32 words, and the row counts must be equal. count_records_device,
newline_positions_device, record_offsets_device, gather_padded_device and
parse_fastq_device are compared leaf by leaf (np.array_equal) with the
reference on the same bytes, including the uncapped record count, `start`,
structure codes and lengths past max_len, and on every case of
chip_smoke.py's DEVICE_PARSE_EDGE_CASES. CPU tensors reach the plain
versions (newline_positions_torch, record_offsets_torch,
gather_padded_torch, count_records_torch); a CUDA path whose kernels cannot
load raises. The CUDA kernels are held against the plain versions on the
card, on the same edge cases; those cases skip where there is no card.
"""

import importlib.util
import os

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
EDGE_CASES = CHIP_SMOKE.DEVICE_PARSE_EDGE_CASES


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


def _class_pairs():
    """Every byte value beside each class byte, on both sides: v c v' c ...
    for the three classes, at every offset within a word."""
    return b"".join(bytes([v, c]) for c in b"\n@+" for v in range(256))


BITMAP_INPUTS = {
    "records": lambda: b"@r1\nACGT\n+\nIIII\n" * 8,
    "class_pairs": _class_pairs,
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


@pytest.mark.parametrize("offset", [1, 5, 16])
def test_bitmaps_match_pallas_kernel_on_a_view(offset):
    """A chunk that starts `offset` bytes into its storage (the class pairs
    and a soup), as a caller's slice chunk[offset:offset + 128k] gives it."""
    ref = _ref()
    data = _class_pairs() + _structural_soup(1 << 12, 4)
    n = (len(data) - offset) // 128 * 128
    view = _t(data)[offset:offset + n]
    assert view.storage_offset() == offset and view.is_contiguous()
    want = ref.structural_bitmaps(
        np.frombuffer(data, np.uint8)[offset:offset + n])
    _eq(scan.structural_bitmaps(view), want)


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


def _card_soup(n, seed):
    """n bytes on the card: a soup of the class bytes and random bytes."""
    rng = np.random.default_rng(seed)
    host = np.where(rng.random(n) < 0.5,
                    rng.choice(np.frombuffer(b"\n@+", np.uint8), n),
                    rng.integers(0, 256, n, dtype=np.uint8)).astype(np.uint8)
    return torch.from_numpy(host).cuda()


# chunks that exist only on the card: sizes around the kernel's steps,
# views off 16-byte alignment, and a full 256 MiB chunk
CARD_CHUNKS = {
    **{"N=%d" % n: (lambda n=n: _card_soup(n, n))
       for n in [128, 256, 384] + [128 * (2 ** k + 1)
                                   for k in (3, 7, 10, 13, 17)]},
    "chunk[16:]": lambda: _card_soup(128 * 1031 + 16, 7)[16:],
    "chunk[1:1+128k]": lambda: _card_soup(128 * 1031 + 1, 8)[1:],
    "chunk[5:5+128k] of the class pairs": lambda: _t(
        b"\0" * 5 + _class_pairs() * 2).cuda()[5:5 + 3072],
    "256 MiB": lambda: _card_soup(256 << 20, 9),
}


@pytest.mark.parametrize("name", sorted(BITMAP_INPUTS) + sorted(CARD_CHUNKS))
def test_bitmaps_kernel_matches_plain_on_card(name):
    _needs_card()
    if name in BITMAP_INPUTS:
        chunk = scan._pad_lane(_t(BITMAP_INPUTS[name]())).cuda()
    else:
        chunk = CARD_CHUNKS[name]()
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


def _edge_chunk(case, device="cpu"):
    """The case's chunk as a view `off` bytes into its storage."""
    off = case["off"]
    host = np.concatenate([np.zeros(off, np.uint8), case["data"]])
    chunk = torch.from_numpy(host).to(device)[off:]
    assert chunk.storage_offset() == off
    return chunk


@pytest.mark.parametrize("label", EDGE_CASES)
def test_edge_cases_match_reference(label):
    """Every device-parse function of the port against the reference on
    one edge case, leaf by leaf. The reference cannot take an empty chunk
    (its compaction indexes the chunk's last block); there the port's
    positions are all n = 0 and its counts 0."""
    ref = _ref()
    import jax.numpy as jnp

    case = CHIP_SMOKE.device_parse_edge_case(label, 0)
    arr = case["data"]
    chunk = _edge_chunk(case)
    mr, ml, mc = case["max_records"], case["max_len"], case["max_count"]
    assert int(scan.count_records_device(chunk)) \
        == int(np.count_nonzero(arr == 10)) // 4
    if not len(arr):
        pos, count = scan.newline_positions_device(chunk, mc)
        assert pos.tolist() == [0] * mc and int(count) == 0
        return
    _eq(scan.newline_positions_device(chunk, mc),
        ref.newline_positions_device(arr, max_count=mc))
    want = ref.record_offsets_device(arr, max_records=mr,
                                     start=jnp.int32(case["start"]))
    _eq(scan.record_offsets_device(chunk, mr, case["start"]), want)
    offsets = want[0] if case["offsets"] is None else case["offsets"]
    _eq(scan.gather_padded_device(chunk, torch.from_numpy(
        np.array(offsets)), mr, ml),
        ref.gather_padded_device(arr, jnp.asarray(offsets), mr, ml))
    _eq(scan.parse_fastq_device(chunk, mr, ml),
        ref.parse_fastq_device(arr, max_records=mr, max_len=ml))


def test_dispatch_cpu_takes_the_plain_versions(monkeypatch):
    """CPU tensors reach the plain versions and count no launch."""
    case = CHIP_SMOKE.device_parse_edge_case("missing '+'", 0)
    chunk = _edge_chunk(case)
    mr, ml = case["max_records"], case["max_len"]
    reached = []
    for name in ("newline_positions_torch", "record_offsets_torch",
                 "gather_padded_torch", "count_records_torch"):
        def spy(*a, _fn=getattr(scan, name), _name=name, **k):
            reached.append(_name)
            return _fn(*a, **k)
        monkeypatch.setattr(scan, name, spy)
    counters = (scan.newline_positions_device, scan.record_offsets_device,
                scan.gather_padded_device, scan.count_records_device,
                scan.structural_bitmaps)
    before = [f.launches for f in counters]
    scan.newline_positions_device(chunk, 8)
    scan.parse_fastq_device(chunk, mr, ml)
    scan.count_records_device(chunk)
    assert reached == ["newline_positions_torch", "record_offsets_torch",
                       "gather_padded_torch", "count_records_torch"]
    assert [f.launches for f in counters] == before


def test_device_parse_cuda_dispatch_raises_when_kernels_cannot_load(
        monkeypatch):
    """A CUDA chunk whose kernels cannot load raises from every
    device-parse function; no plain version runs, no launch is counted."""
    def fail():
        raise RuntimeError("kernel library unavailable (test)")

    def twin_must_not_run(*a, **k):
        raise AssertionError("plain version reached from the CUDA branch")

    monkeypatch.setattr(_kernels, "load", fail)
    for name in ("newline_positions_torch", "record_offsets_torch",
                 "gather_padded_torch", "count_records_torch",
                 "structural_bitmaps_torch", "_compact_positions"):
        monkeypatch.setattr(scan, name, twin_must_not_run)
    counters = (scan.newline_positions_device, scan.record_offsets_device,
                scan.gather_padded_device, scan.count_records_device,
                scan.structural_bitmaps)
    before = [f.launches for f in counters]
    chunk = torch.Tensor._make_subclass(
        _LooksCuda, _t(b"@r\nACGT\n+\nIIII\n" * 20))
    offsets = torch.full((4, 5), -1, dtype=torch.int32)
    for call in (lambda: scan.newline_positions_device(chunk, 16),
                 lambda: scan.record_offsets_device(chunk, 4),
                 lambda: scan.gather_padded_device(chunk, offsets, 4, 8),
                 lambda: scan.parse_fastq_device(chunk, 4, 8),
                 lambda: scan.count_records_device(chunk)):
        with pytest.raises(RuntimeError, match="kernel library unavailable"):
            call()
    assert [f.launches for f in counters] == before


def test_device_parse_refuses_bad_arguments():
    chunk = _t(b"@r\nAC\n+\nII\n")
    with pytest.raises(ValueError, match="start"):
        scan.record_offsets_device(chunk, 4, start=-1)
    with pytest.raises(ValueError, match="max_count"):
        scan.newline_positions_device(chunk, -1)
    with pytest.raises(ValueError, match=r"offsets must be \[4, 5\]"):
        scan.gather_padded_device(chunk, torch.zeros((3, 5), dtype=torch.int32),
                                  4, 8)
    with pytest.raises(ValueError, match="unsupported device"):
        scan.record_offsets_device(chunk.to("meta"), 4)


def test_parse_tiles_match_the_kernel_source():
    """The wrappers size the kernels' scratch by PARSE_TILE_BYTES, which
    must be csrc/parse.cu's kTile; tiles start at the address rounded
    down to 16 bytes."""
    with open(os.path.join(_kernels.CSRC, "parse.cu")) as f:
        assert ("constexpr int kTile = %d;" % scan.PARSE_TILE_BYTES
                in f.read())
    t = scan.PARSE_TILE_BYTES
    assert scan.parse_tiles(4096, 0) == 0
    assert scan.parse_tiles(4096, 1) == 1
    assert scan.parse_tiles(4096, t) == 1
    assert scan.parse_tiles(4096 + 15, t - 15) == 1
    assert scan.parse_tiles(4096 + 15, t - 14) == 2
    assert scan.parse_tiles(4096 + 3, 3 * t) == 4


@pytest.mark.parametrize("label", EDGE_CASES)
def test_device_parse_kernels_match_plain_on_card(label):
    """Each device-parse kernel against its plain version on the card on
    one edge case, every leaf exact, its launches counted. The plain
    record pass cannot take an empty chunk: there only the compaction and
    the record count are held."""
    _needs_card()
    case = CHIP_SMOKE.device_parse_edge_case(label, 0)
    chunk = _edge_chunk(case, "cuda")
    mr, ml, mc = case["max_records"], case["max_len"], case["max_count"]
    before = scan.newline_positions_device.launches
    got = scan.newline_positions_device(chunk, mc)
    assert scan.newline_positions_device.launches == before + 1
    _eq_card(got, scan.newline_positions_torch(chunk, mc))
    before = scan.count_records_device.launches
    _eq_card((scan.count_records_device(chunk),),
             (scan.count_records_torch(chunk),))
    assert scan.count_records_device.launches == before + 1
    if not chunk.numel():
        return
    before = scan.record_offsets_device.launches
    got = scan.record_offsets_device(chunk, mr, case["start"])
    assert scan.record_offsets_device.launches == before + 1
    _eq_card(got, scan.record_offsets_torch(chunk, mr, case["start"]))
    offsets = (got[0] if case["offsets"] is None
               else torch.from_numpy(case["offsets"]).cuda())
    before = scan.gather_padded_device.launches
    got = scan.gather_padded_device(chunk, offsets, mr, ml)
    assert scan.gather_padded_device.launches == before + 1
    _eq_card(got, scan.gather_padded_torch(chunk, offsets, mr, ml))
    _eq_card(scan.parse_fastq_device(chunk, mr, ml),
             (*scan.gather_padded_torch(
                 chunk, scan.record_offsets_torch(chunk, mr)[0], mr, ml),
              *scan.record_offsets_torch(chunk, mr)[1:]))


def _eq_card(got, want):
    torch.cuda.synchronize()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.is_cuda and g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.parametrize("off", CHIP_SMOKE.MANY_TILE_OFFSETS)
@pytest.mark.parametrize("label", CHIP_SMOKE.MANY_TILE_CASES)
def test_many_tiles_kernels_match_plain_on_card(label, off):
    """The compaction (positions and rows, each tile's rank by look-back),
    the record pass and the record count on 1,024 tiles and more, at views
    off 16-byte alignment, run MANY_TILE_RUNS times: every leaf equal to
    the plain version's each time."""
    _needs_card()
    data = CHIP_SMOKE.device_parse_many_tiles(label, 0)
    dev = torch.zeros(len(data) + off, dtype=torch.uint8, device="cuda")
    dev[off:].copy_(torch.from_numpy(data))
    chunk = dev[off:]
    mr = int(np.count_nonzero(data == 10)) // 4 + 3
    calls = ((lambda: scan.newline_positions_device(chunk, 4 * mr + 2),
              scan.newline_positions_torch(chunk, 4 * mr + 2)),
             (lambda: scan.record_offsets_device(chunk, mr),
              scan.record_offsets_torch(chunk, mr)),
             (lambda: (scan.count_records_device(chunk),),
              (scan.count_records_torch(chunk),)))
    for kernel, want in calls:
        for _ in range(CHIP_SMOKE.MANY_TILE_RUNS):
            _eq_card(kernel(), want)
