"""Parity: the PyTorch port's validate + decode against
blazeseq_tpu/ops/validate.py.

The plain torch version is held against the Pallas kernel
validate_decode_pallas (interpret mode on the CPU, as the reference's own
tests run it) and against validate_decode_xla for the col_offset cases;
codes and phred must be equal (np.array_equal). The edge cases are the ones
the kernel's vector and byte paths meet: widths that are and are not
multiples of 16, lengths below 0 and past L, column offsets past L,
quality bytes at the schema's bounds and at 0x7F / 0x80 / 0xFF, row views
with a storage offset. The CUDA kernel is held against the plain version on
the card, and that case skips where there is no CUDA device.
"""

import numpy as np
import pytest
import torch

from blazeseq_tpu.fastq.quality import parse_schema
from blazeseq_tpu_torch.ops.validate import (lane_group, validate_decode,
                                             validate_decode_torch)

SANGER = parse_schema("sanger")


def _ref():
    """jax.numpy and the reference validate module. Imported per test, so
    that the kernel cases also run where only the port is installed."""
    ref = pytest.importorskip("blazeseq_tpu.ops.validate")
    import jax.numpy as jnp

    return jnp, ref


def _inputs(n, L, seed):
    """seq/qual with high-bit bytes, out-of-range (and below-offset)
    quality bytes, and lengths of 0, within L and beyond L."""
    rng = np.random.default_rng(seed)
    seq = rng.choice(np.frombuffer(b"ACGTNacgt", np.uint8), (n, L))
    qual = rng.integers(33, 80, (n, L)).astype(np.uint8)
    k = max(1, n // 6)
    seq[rng.integers(0, n, k), rng.integers(0, L, k)] |= 0x80
    qual[rng.integers(0, n, k), rng.integers(0, L, k)] |= 0x80
    qual[rng.integers(0, n, k), rng.integers(0, L, k)] = 20
    qual[rng.integers(0, n, k), rng.integers(0, L, k)] = 127
    lengths = rng.integers(0, L + 1, n).astype(np.int32)
    lengths[:3] = 0
    lengths[3:6] = L + 37
    lengths[6:9] = L
    return seq, qual, lengths


def _port(seq, qual, lengths, **kw):
    codes, phred = validate_decode_torch(
        torch.from_numpy(seq), torch.from_numpy(qual),
        torch.from_numpy(lengths), SANGER.LOWER, SANGER.UPPER, SANGER.OFFSET,
        **kw)
    return codes.numpy(), phred.numpy()


FLAGS = [(True, True), (True, False), (False, True), (False, False)]
EDGE_WIDTHS = [1, 15, 17, 100, 513]


def _edge_inputs(n, L, seed):
    """A third of the rows clean, a third with one quality byte at an edge
    (exactly q_lo or q_hi, 0x7F, 0x80, 0xFF, below the offset so that the
    decode wraps, 0), a third with a high-bit seq byte, each at a random
    column in or past the row's length; lengths from -5 to L + 9, both ends
    and 0, 1 and L included."""
    rng = np.random.default_rng(seed)
    seq = rng.choice(np.frombuffer(b"ACGTNacgt", np.uint8), (n, L))
    qual = rng.integers(SANGER.LOWER, SANGER.UPPER + 1, (n, L),
                        dtype=np.uint8)
    rows = np.arange(n)
    col = rng.integers(0, L, n)
    kind = rng.integers(0, 3, n)
    edge = rng.choice(np.array([SANGER.LOWER, SANGER.UPPER, 0x7F, 0x80, 0xFF,
                                20, 0], np.uint8), n)
    qual[rows, col] = np.where(kind == 1, edge, qual[rows, col])
    seq[rows, col] |= np.where(kind == 2, 0x80, 0).astype(np.uint8)
    lengths = rng.integers(-5, L + 10, n).astype(np.int32)
    ends = np.array([-5, 0, 1, L, L + 9], np.int32)[:n]
    lengths[:len(ends)] = ends
    return seq, qual, lengths


@pytest.mark.parametrize("check_ascii,check_quality", FLAGS)
def test_twin_matches_pallas_kernel(check_ascii, check_quality):
    jnp, ref = _ref()
    seq, qual, lengths = _inputs(40, 128, seed=3)
    jc, jp = ref.validate_decode_pallas(
        jnp.asarray(seq), jnp.asarray(qual), jnp.asarray(lengths),
        SANGER.LOWER, SANGER.UPPER, SANGER.OFFSET, check_ascii=check_ascii,
        check_quality=check_quality)
    tc, tp = _port(seq, qual, lengths, check_ascii=check_ascii,
                   check_quality=check_quality)
    np.testing.assert_array_equal(np.asarray(jc), tc)
    np.testing.assert_array_equal(np.asarray(jp), tp)
    # the cases are all present: both codes, and wrapped phred bytes
    if check_ascii and check_quality:
        assert {0, 4, 5} <= set(tc.tolist())
    assert (tp > 200).any()  # q < offset wraps in u8


@pytest.mark.parametrize("col_offset", [0, 64, 128])
@pytest.mark.parametrize("check_ascii,check_quality", FLAGS[:3])
def test_twin_matches_xla_col_offset(col_offset, check_ascii, check_quality):
    jnp, ref = _ref()
    seq, qual, lengths = _inputs(64, 128, seed=4 + col_offset)
    lengths = lengths + col_offset // 2
    jc, jp = ref.validate_decode_xla(
        jnp.asarray(seq), jnp.asarray(qual), jnp.asarray(lengths),
        jnp.int32(SANGER.LOWER), jnp.int32(SANGER.UPPER),
        jnp.int32(SANGER.OFFSET), check_ascii=check_ascii,
        check_quality=check_quality, col_offset=col_offset)
    tc, tp = _port(seq, qual, lengths, check_ascii=check_ascii,
                   check_quality=check_quality, col_offset=col_offset)
    np.testing.assert_array_equal(np.asarray(jc), tc)
    np.testing.assert_array_equal(np.asarray(jp), tp)


@pytest.mark.parametrize("L", EDGE_WIDTHS)
@pytest.mark.parametrize("check_ascii,check_quality", FLAGS)
def test_twin_matches_pallas_kernel_at_edges(L, check_ascii, check_quality):
    jnp, ref = _ref()
    seq, qual, lengths = _edge_inputs(24, L, seed=L)
    jc, jp = ref.validate_decode_pallas(
        jnp.asarray(seq), jnp.asarray(qual), jnp.asarray(lengths),
        SANGER.LOWER, SANGER.UPPER, SANGER.OFFSET, check_ascii=check_ascii,
        check_quality=check_quality)
    tc, tp = _port(seq, qual, lengths, check_ascii=check_ascii,
                   check_quality=check_quality)
    np.testing.assert_array_equal(np.asarray(jc), tc)
    np.testing.assert_array_equal(np.asarray(jp), tp)


@pytest.mark.parametrize("L", EDGE_WIDTHS)
@pytest.mark.parametrize("col_offset", ["0", "7", "L+3"])
@pytest.mark.parametrize("check_ascii,check_quality", FLAGS)
def test_twin_matches_xla_at_edges(L, col_offset, check_ascii,
                                   check_quality):
    jnp, ref = _ref()
    col_offset = L + 3 if col_offset == "L+3" else int(col_offset)
    seq, qual, lengths = _edge_inputs(24, L, seed=2 * L + col_offset)
    jc, jp = ref.validate_decode_xla(
        jnp.asarray(seq), jnp.asarray(qual), jnp.asarray(lengths),
        jnp.int32(SANGER.LOWER), jnp.int32(SANGER.UPPER),
        jnp.int32(SANGER.OFFSET), check_ascii=check_ascii,
        check_quality=check_quality, col_offset=col_offset)
    tc, tp = _port(seq, qual, lengths, check_ascii=check_ascii,
                   check_quality=check_quality, col_offset=col_offset)
    np.testing.assert_array_equal(np.asarray(jc), tc)
    np.testing.assert_array_equal(np.asarray(jp), tp)


@pytest.mark.parametrize("L", [15, 16, 17, 100])
def test_twin_on_a_row_view_with_a_storage_offset(L):
    """seq[1:] and qual[1:] of a bigger batch: a view whose data starts L
    bytes into its storage (off 16-byte alignment unless L % 16 == 0)."""
    jnp, ref = _ref()
    seq, qual, lengths = _edge_inputs(25, L, seed=3 * L)
    s, q = torch.from_numpy(seq)[1:], torch.from_numpy(qual)[1:]
    assert s.storage_offset() == L and s.is_contiguous()
    tc, tp = validate_decode(s, q, torch.from_numpy(lengths[1:]), SANGER)
    jc, jp = ref.validate_decode_xla(
        jnp.asarray(seq[1:]), jnp.asarray(qual[1:]), jnp.asarray(lengths[1:]),
        jnp.int32(SANGER.LOWER), jnp.int32(SANGER.UPPER),
        jnp.int32(SANGER.OFFSET))
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())


@pytest.mark.parametrize("L,misaligned,group", [
    (0, 0, 0), (1, 0, 0), (15, 0, 0), (17, 0, 0), (100, 0, 0),
    (16, 0, 1), (32, 0, 2), (48, 0, 4), (64, 0, 4), (256, 0, 16),
    (384, 0, 32), (512, 0, 32), (1024, 0, 32), (4096, 0, 32),
    (256, 1, 0), (256, 8, 0), (1024, 16, 32)])
def test_lane_group_picks_the_kernel_path(L, misaligned, group):
    """G = min(32, next_pow2(L / 16)) lanes per row on the vector path;
    0 (the byte path) for widths off a multiple of 16 and pointers off
    16-byte alignment."""
    base = 1 << 20
    assert lane_group(L, base, base + misaligned, base) == group
    assert lane_group(L, base + misaligned) == group


def test_dispatch_cpu_takes_the_plain_version():
    seq, qual, lengths = _inputs(32, 128, seed=9)
    before = validate_decode.launches
    got = validate_decode(torch.from_numpy(seq), torch.from_numpy(qual),
                          torch.from_numpy(lengths), SANGER)
    want = _port(seq, qual, lengths)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert validate_decode.launches == before  # no kernel on the CPU


def test_dispatch_refuses_other_devices():
    t = torch.zeros((4, 128), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        validate_decode(t, t, torch.zeros(4, dtype=torch.int32,
                                          device="meta"), SANGER)


class _LooksCuda(torch.Tensor):
    """A CPU tensor that reports is_cuda, to reach the CUDA branch's checks
    without a card."""

    @property
    def is_cuda(self):
        return True


def _bad_batches(make):
    """(label, seq, qual, lengths, error, message) for each batch the CUDA
    branch refuses; `make` turns a numpy array into a tensor."""
    u8 = np.zeros((4, 32), np.uint8)
    i32 = np.full(4, 10, np.int32)
    s, ln = make(u8), make(i32)
    return [
        ("seq dtype", make(u8.astype(np.int32)), s, ln, TypeError,
         "seq must be torch.uint8"),
        ("lengths dtype", s, s, make(i32.astype(np.int64)), TypeError,
         "lengths must be torch.int32"),
        ("qual not contiguous", s, make(np.zeros((32, 4), np.uint8)).t(), ln,
         ValueError, "qual must be contiguous"),
        ("qual shape", s, make(np.zeros((4, 16), np.uint8)), ln, ValueError,
         r"seq and qual must both be \[n, L\]"),
        ("seq rank", make(u8.reshape(-1)), make(u8.reshape(-1)), ln,
         ValueError, r"seq and qual must both be \[n, L\]"),
        ("lengths shape", s, s, make(np.full(3, 10, np.int32)), ValueError,
         r"lengths must be \[n\]"),
    ]


def test_cuda_branch_refuses_bad_batches_before_loading(monkeypatch):
    """Every refusal of the CUDA branch happens before the kernel library
    is loaded, and nothing is counted."""
    from blazeseq_tpu_torch import _kernels

    def must_not_load():
        raise AssertionError("kernel library loaded for a refused batch")

    monkeypatch.setattr(_kernels, "load", must_not_load)
    before = validate_decode.launches
    cases = _bad_batches(lambda a: torch.Tensor._make_subclass(
        _LooksCuda, torch.from_numpy(a)))
    for label, seq, qual, lengths, err, msg in cases:
        with pytest.raises(err, match=msg):
            validate_decode(seq, qual, lengths, SANGER)
    assert validate_decode.launches == before


def test_kernel_refuses_bad_batches_on_card():
    """The wrapper's checks on real CUDA tensors raise what they raise
    without a card, and launch nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    before = validate_decode.launches
    for label, seq, qual, lengths, err, msg in _bad_batches(
            lambda a: torch.from_numpy(a).cuda()):
        with pytest.raises(err, match=msg):
            validate_decode(seq, qual, lengths, SANGER)
    with pytest.raises(ValueError, match="lengths is not on a CUDA device"):
        u8 = torch.zeros((4, 32), dtype=torch.uint8, device="cuda")
        validate_decode(u8, u8, torch.zeros(4, dtype=torch.int32), SANGER)
    assert validate_decode.launches == before


def _card_copy(a, misaligned):
    """`a` on the card; with `misaligned`, as a contiguous view starting one
    byte into its storage, so that the kernel takes its byte path."""
    if not misaligned:
        return torch.from_numpy(a).cuda()
    flat = torch.empty(a.size + 1, dtype=torch.uint8, device="cuda")
    flat[1:].copy_(torch.from_numpy(a.reshape(-1)))
    return flat[1:].view(a.shape)


@pytest.mark.parametrize("L", [1, 15, 16, 17, 100, 256, 384, 512, 513, 1024,
                               4096])
@pytest.mark.parametrize("n", [1, 3, 4096, 32768])
def test_kernel_matches_twin_on_card(L, n):
    """Every flag pair, col_offset 0, 7 and L + 3, lengths -5..L+9, quality
    edges; aligned rows (the vector path where L % 16 == 0) and rows one
    byte off alignment (the byte path)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    seq, qual, lengths = _edge_inputs(n, L, seed=L + n)
    dlen = torch.from_numpy(lengths).cuda()
    for misaligned in (False, True):
        dseq, dqual = _card_copy(seq, misaligned), _card_copy(qual, misaligned)
        want_group = 0 if misaligned else lane_group(L, 0)
        assert lane_group(L, dseq.data_ptr(), dqual.data_ptr()) == want_group
        for col_offset in (0, 7, L + 3):
            for ca, cq in FLAGS:
                kw = dict(check_ascii=ca, check_quality=cq,
                          col_offset=col_offset)
                before = validate_decode.launches
                got = validate_decode(dseq, dqual, dlen, SANGER, **kw)
                want = validate_decode_torch(dseq, dqual, dlen, SANGER.LOWER,
                                             SANGER.UPPER, SANGER.OFFSET,
                                             **kw)
                torch.cuda.synchronize()
                assert validate_decode.launches == before + 1
                for g, w in zip(got, want):
                    assert torch.equal(g, w), (misaligned, kw)
