"""Parity: the PyTorch port's validate + decode against
blazeseq_tpu/ops/validate.py.

The plain torch version is held against the Pallas kernel
validate_decode_pallas (interpret mode on the CPU, as the reference's own
tests run it) and against validate_decode_xla for the col_offset cases;
codes and phred must be equal (np.array_equal). The CUDA kernel is held
against the plain version on the card, and that case skips where there is
no CUDA device.
"""

import numpy as np
import pytest
import torch

from blazeseq_tpu.fastq.quality import parse_schema
from blazeseq_tpu_torch.ops.validate import (validate_decode,
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


@pytest.mark.parametrize("L", [256, 384])
@pytest.mark.parametrize("col_offset", [0, 128])
def test_kernel_matches_twin_on_card(L, col_offset):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    seq, qual, lengths = _inputs(4096, L, seed=L + col_offset)
    d = [torch.from_numpy(a).cuda() for a in (seq, qual, lengths)]
    for ca, cq in FLAGS:
        before = validate_decode.launches
        got = validate_decode(*d, SANGER, check_ascii=ca, check_quality=cq,
                              col_offset=col_offset)
        want = validate_decode_torch(*d, SANGER.LOWER, SANGER.UPPER,
                                     SANGER.OFFSET, check_ascii=ca,
                                     check_quality=cq, col_offset=col_offset)
        torch.cuda.synchronize()
        assert validate_decode.launches == before + 1
        for g, w in zip(got, want):
            assert torch.equal(g, w)
