"""Parity: the PyTorch port's uniform-layout QC step against
blazeseq_tpu/ops/fused_qc.py::fused_uniform_qc (the Pallas kernel, in
interpret mode on the CPU) and blazeseq_tpu/ops/uniform_qc.py::uniform_qc
(the production XLA step).

Mirrors the cases of tests/test_fused_qc.py and the eq-mode case of
tests/test_adaptive_hist.py. The template verdict must agree; on accepted
chunks every QCStats leaf must be equal (np.array_equal). The CUDA kernel is
held against the plain version on the card; those cases skip where there is
no CUDA device. Also checks detect_uniform_layout against the reference,
malformed heads included.
"""

import numpy as np
import pytest
import torch

import blazeseq_tpu as bt
from blazeseq_tpu.fastq.quality import parse_schema
from blazeseq_tpu_torch import _kernels
from blazeseq_tpu_torch.ops.uniform_parse import (UniformLayout,
                                                  detect_uniform_layout)
from blazeseq_tpu_torch.ops.uniform_qc import uniform_qc, uniform_qc_torch

IMPLS = ("pallas", "xla")
LUT = np.array([2, 12, 23, 37])
EDGES = np.array([7, 18, 30])


def _ref():
    """jax.numpy and the reference's (fused_uniform_qc, uniform_qc,
    detect_uniform_layout). Imported per test, so that the kernel cases
    also run where only the port is installed."""
    fused = pytest.importorskip("blazeseq_tpu.ops.fused_qc")
    xla = pytest.importorskip("blazeseq_tpu.ops.uniform_qc")
    parse = pytest.importorskip("blazeseq_tpu.ops.uniform_parse")
    import jax.numpy as jnp

    return jnp, dict(pallas=fused.fused_uniform_qc, xla=xla.uniform_qc), \
        parse.detect_uniform_layout


def _uniform_corpus(n_reads, read_len, schema="sanger"):
    buf = bytes(bt.generate_synthetic_fastq_buffer(
        n_reads, read_len, read_len, 2, 40, schema))
    return np.frombuffer(buf, dtype=np.uint8)


def _kw(lay, width, schema, check_ascii=True, check_quality=True):
    return dict(rs=lay.rs, o1=lay.o1, o2=lay.o2, o3=lay.o3, width=width,
                q_lo=int(schema.LOWER), q_hi=int(schema.UPPER),
                offset=int(schema.OFFSET), check_ascii=check_ascii,
                check_quality=check_quality)


def _run_case(chunk, lay, width, schema_name="sanger", check_ascii=True,
              check_quality=True, pad_records=0, impl="pallas",
              n_valid=None):
    schema = parse_schema(schema_name)
    if n_valid is None:
        n_valid = len(chunk)
    if pad_records:
        chunk = np.concatenate(
            [chunk, np.zeros(pad_records * lay.rs, np.uint8)])
    kw = _kw(lay, width, schema, check_ascii, check_quality)
    jnp, impls, _ = _ref()
    ok_j, st_j = impls[impl](jnp.asarray(chunk), jnp.int32(n_valid), **kw)
    ok_t, st_t = uniform_qc(torch.from_numpy(chunk.copy()), n_valid, **kw)
    assert bool(ok_t) == bool(ok_j)
    if bool(ok_j):
        got = st_t.to_numpy()
        for name, a, b in zip(st_j._fields, st_j, got):
            if a is None:
                assert b is None
                continue
            np.testing.assert_array_equal(np.asarray(a), b,
                                          err_msg="panel " + name)
    return bool(ok_j), st_t


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("read_len", [25, 100, 151])
def test_parity_clean_corpus(read_len, impl):
    chunk = _uniform_corpus(301, read_len)
    lay = detect_uniform_layout(chunk)
    assert lay is not None
    assert _run_case(chunk, lay, 256, pad_records=5, impl=impl)[0]


@pytest.mark.parametrize("impl", IMPLS)
def test_parity_width_truncation(impl):
    # reads longer than the stats window: in-window masking semantics
    chunk = _uniform_corpus(64, 200)
    lay = detect_uniform_layout(chunk)
    assert _run_case(chunk, lay, 128, impl=impl)[0]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("schema_name", ["sanger", "illumina_1.3",
                                         "illumina_1.8", "generic"])
def test_parity_schemas(schema_name, impl):
    schema = parse_schema(schema_name)
    rng = np.random.default_rng(7)
    n, L = 97, 60
    recs = []
    for i in range(n):
        q = rng.integers(schema.LOWER, schema.UPPER + 1, L).astype(np.uint8)
        recs.append(b"@r%07d\n" % i
                    + bytes(rng.choice(list(b"ACGT"), L).astype(np.uint8))
                    + b"\n+\n" + q.tobytes() + b"\n")
    chunk = np.frombuffer(b"".join(recs), np.uint8)
    lay = detect_uniform_layout(chunk)
    assert lay is not None
    assert _run_case(chunk, lay, 64, schema_name, impl=impl)[0]


@pytest.mark.parametrize("impl", IMPLS)
def test_parity_no_quality_check_full_hist(impl):
    chunk = _uniform_corpus(50, 80).copy()
    lay = detect_uniform_layout(chunk)
    qcol = lay.o3 + 1
    chunk[qcol] = 126  # clamps to bin 63
    chunk[lay.rs + qcol] = 33  # bin 0
    assert _run_case(chunk, lay, 128, check_quality=False, impl=impl)[0]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("mutate", ["newline", "at", "plus", "ascii",
                                    "quality"])
def test_rejects_violations(mutate, impl):
    chunk = _uniform_corpus(40, 50).copy()
    lay = detect_uniform_layout(chunk)
    r = 17 * lay.rs
    col = {"newline": lay.o1, "at": 0, "plus": lay.o2 + 1,
           "ascii": lay.o1 + 2, "quality": lay.o3 + 2}[mutate]
    val = {"newline": ord("x"), "at": ord("#"), "plus": ord("-"),
           "ascii": 0x80 | ord("A"), "quality": 1}[mutate]
    chunk[r + col] = val
    assert _run_case(chunk, lay, 128, impl=impl)[0] is False


@pytest.mark.parametrize("impl", IMPLS)
def test_violation_beyond_n_valid_ignored(impl):
    chunk = _uniform_corpus(30, 50).copy()
    lay = detect_uniform_layout(chunk)
    chunk[25 * lay.rs] = ord("#")  # corrupt a record past n_valid
    ok, st = _run_case(chunk, lay, 128, impl=impl, n_valid=20 * lay.rs)
    assert ok
    assert int(st.reads) == 20


def _binned(n=512, L=100):
    arr = _uniform_corpus(n, L)
    lay = detect_uniform_layout(arr)
    arr = arr.reshape(-1, lay.rs).copy()
    q = arr[:, lay.o3 + 1:lay.rs - 1].astype(np.int32) - 33
    arr[:, lay.o3 + 1:lay.rs - 1] = (LUT[np.searchsorted(EDGES, q)]
                                     + 33).astype(np.uint8)
    return arr, lay


@pytest.mark.parametrize("out_of_set", [False, True])
def test_eq_mode_parity(out_of_set):
    arr, lay = _binned()
    if out_of_set:
        arr[0, lay.o3 + 1] = 33 + 9  # lands in the remainder bin
    kw = _kw(lay, 128, parse_schema("sanger"))
    vals = (2, 12, 23, 37)
    jnp, impls, _ = _ref()
    ok_j, st_j = impls["xla"](jnp.asarray(arr), jnp.int32(arr.size),
                              hist_vals=vals, **kw)
    ok_t, st_t = uniform_qc(torch.from_numpy(arr), arr.size, hist_vals=vals,
                            **kw)
    assert bool(ok_j) and bool(ok_t)
    for name, a, b in zip(st_j._fields, st_j, st_t.to_numpy()):
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), b, err_msg=name)
    full = uniform_qc(torch.from_numpy(arr), arr.size, **kw)[1].qual_hist
    if out_of_set:
        assert int(st_t.qual_hist[38]) == 1  # max(vals) + 1
    else:
        assert torch.equal(st_t.qual_hist, full)


def test_one_and_two_dim_chunks_agree():
    arr, lay = _binned(200, 80)
    kw = _kw(lay, 128, parse_schema("sanger"))
    ok2, st2 = uniform_qc(torch.from_numpy(arr), arr.size, **kw)
    ok1, st1 = uniform_qc(torch.from_numpy(arr.reshape(-1)), arr.size, **kw)
    assert bool(ok1) and bool(ok2)
    for a, b in zip(st1, st2):
        if a is not None:
            assert torch.equal(a, b)


def test_preconditions_raise():
    arr, lay = _binned(50, 60)
    kw = _kw(lay, 128, parse_schema("sanger"))
    c = torch.from_numpy(arr)
    with pytest.raises(ValueError, match="eq-mode"):
        uniform_qc(c, arr.size, hist_vals=(2, 63), **kw)  # no remainder bin
    with pytest.raises(ValueError, match="multiple of rs"):
        uniform_qc(c.reshape(-1)[:-1], arr.size, **kw)
    with pytest.raises(ValueError, match=r"\[nrec, rs\]"):
        uniform_qc(c[:, :-1], arr.size, **kw)
    with pytest.raises(ValueError, match="outside the chunk"):
        uniform_qc(c, arr.size + lay.rs, **kw)
    with pytest.raises(ValueError, match="unsupported device"):
        uniform_qc(c.to("meta"), arr.size, **kw)


HEADS = {
    "clean": b"@r1\nACGT\n+\nIIII\n@r2\nACGT\n+\nIIII\n",
    "crlf_free_long_header": b"@" + b"x" * 300 + b"\nAC\n+\nII\n",
    "no_newline": b"@r1 ACGT",
    "three_newlines": b"@r1\nACGT\n+\nIIII",
    "no_at": b"r1\nACGT\n+\nIIII\n",
    "no_plus": b"@r1\nACGT\n-\nIIII\n",
    "length_mismatch": b"@r1\nACGT\n+\nIII\n",
    "empty_sequence": b"@r1\n\n+\n\n",
    "empty": b"",
}


@pytest.mark.parametrize("head", list(HEADS))
@pytest.mark.parametrize("start", [0, 3])
def test_detect_uniform_layout_parity(head, start):
    buf = HEADS[head]
    if start:
        buf = b"JNK" + buf
    _, _, j_detect = _ref()
    got = detect_uniform_layout(buf, start)
    want = j_detect(np.frombuffer(buf, np.uint8), start)
    assert (got is None) == (want is None)
    if got is not None:
        assert tuple(got) == tuple(want)
        assert (got.seq_len, got.qual_len) == (want.seq_len, want.qual_len)
        assert isinstance(got, UniformLayout)


@pytest.mark.parametrize("read_len,width", [(25, 128), (151, 256),
                                            (250, 128)])
@pytest.mark.parametrize("hist_vals", [(), (2, 12, 23, 37)])
def test_kernel_matches_twin_on_card(read_len, width, hist_vals):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    arr, lay = _binned(2000, read_len)
    arr[1500, lay.o3 + 3] = 33 + 9
    pad = np.concatenate([arr, np.zeros((9, lay.rs), np.uint8)])
    kw = _kw(lay, width, parse_schema("sanger"))
    c = torch.from_numpy(pad).cuda()
    before = uniform_qc.launches
    ok_k, st_k = uniform_qc(c, arr.size, hist_vals=hist_vals, **kw)
    ok_t, st_t = uniform_qc_torch(c, arr.size, hist_vals=hist_vals, **kw)
    torch.cuda.synchronize()
    assert uniform_qc.launches == before + 1
    assert bool(ok_k) and bool(ok_t)
    for a, b in zip(st_k, st_t):
        if a is not None:
            assert torch.equal(a, b)


def _fixed_records(n, read_len, header_width, seed):
    """u8[n, rs] sanger records with ids of `header_width` bytes: rs is
    odd or even with the width's parity."""
    rng = np.random.default_rng(seed)
    rs = header_width + 2 * read_len + 6
    arr = np.empty((n, rs), np.uint8)
    arr[:, 0] = ord("@")
    arr[:, 1:header_width + 1] = rng.choice(
        np.frombuffer(b"ABCDEF0123:", np.uint8), (n, header_width))
    o1 = header_width + 1
    arr[:, o1] = 10
    arr[:, o1 + 1:o1 + 1 + read_len] = rng.choice(
        np.frombuffer(b"ACGTacgtN", np.uint8), (n, read_len))
    o2 = o1 + 1 + read_len
    arr[:, o2:o2 + 3] = np.frombuffer(b"\n+\n", np.uint8)
    arr[:, o2 + 3:rs - 1] = rng.integers(33, 75, (n, read_len))
    arr[:, rs - 1] = 10
    return arr


@pytest.mark.parametrize("width", [128, 256])
@pytest.mark.parametrize("header_width", [12, 13])
@pytest.mark.parametrize("case", ["clean", "bad_first_row", "bad_last_row",
                                  "bad_tail_row", "eq_outside_set"])
def test_kernel_tiles_on_card(case, header_width, width):
    """The kernel's tiling: nrec_valid ending inside a tile, a violation in
    the first and the last row of a staged tile and in the rows past the
    last whole tile, odd and even record sizes, two stats widths, and the
    binned eq-mode with a value outside the set; every leaf equal to the
    plain version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    arr = _fixed_records(4000, 150, header_width, seed=header_width + width)
    rs = arr.shape[1]
    assert rs % 2 == header_width % 2
    R = _kernels.load().bs_uniform_qc_tile_rows(rs)
    n_tiles = 4000 // R - 1
    n_valid = n_tiles * R + R // 2 + 1  # ends inside a tile
    lay = detect_uniform_layout(arr)
    assert lay.rs == rs
    arr[n_valid + 1, 0] = ord("#")  # past nrec_valid: ignored
    hist_vals = ()
    if case == "bad_first_row":
        arr[2 * R, lay.o2 + 1] = ord("-")
    elif case == "bad_last_row":
        arr[3 * R - 1, lay.o3 + 2] = 0x80 | 40
    elif case == "bad_tail_row":
        arr[n_valid - 1, lay.o1] = ord("x")
    elif case == "eq_outside_set":
        q = arr[:, lay.o3 + 1:rs - 1].astype(np.int32) - 33
        arr[:, lay.o3 + 1:rs - 1] = LUT[np.searchsorted(EDGES, q)] + 33
        arr[n_valid - 2, lay.o3 + 1] = 33 + 9
        hist_vals = (2, 12, 23, 37)
    kw = _kw(lay, width, parse_schema("sanger"))
    c = torch.from_numpy(arr).cuda()
    ok_k, st_k = uniform_qc(c, n_valid * rs, hist_vals=hist_vals, **kw)
    ok_t, st_t = uniform_qc_torch(c, n_valid * rs, hist_vals=hist_vals, **kw)
    torch.cuda.synchronize()
    assert bool(ok_k) == bool(ok_t) == case.startswith(("clean", "eq"))
    for a, b in zip(st_k, st_t):
        if a is not None:
            assert torch.equal(a, b)
    assert int(st_k.reads) == n_valid
