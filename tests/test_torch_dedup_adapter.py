"""Parity: the PyTorch port's duplication hashes and adapter scan
(blazeseq_tpu_torch/ops/dedup.py, ops/adapter.py) against
blazeseq_tpu/ops/dedup.py and ops/adapter.py.

`read_hashes` must equal the reference's two wrapping 32-bit hashes bit for
bit (duplicate counts depend on their collisions), on seeded batches with
padding rows, reads longer than the row and 0xFF bytes. `adapter_content`
must equal the reference's panel, including a match that ends exactly at
the last column. The numpy helpers are copies and must agree too. Every
value is an integer: np.array_equal throughout. The card cases hold the
CUDA tensors' results against the CPU's and skip where there is no CUDA
device.
"""

import numpy as np
import pytest
import torch

from blazeseq_tpu_torch.ops import adapter as ad
from blazeseq_tpu_torch.ops import dedup

ADAPTER = b"AGATCGGAAGAG"


def _ref():
    jnp = pytest.importorskip("jax.numpy")
    from blazeseq_tpu.ops import adapter as ref_ad
    from blazeseq_tpu.ops import dedup as ref_dedup

    return jnp, ref_ad, ref_dedup


def _batch(n, L, seed, n_records=None):
    """seq u8[n, L] (ACGTN, some lower case, some 0xFF), lengths with 0, L
    and beyond L, adapters planted (one ending at the last column), and a
    block of duplicated rows."""
    rng = np.random.default_rng(seed)
    seq = rng.choice(np.frombuffer(b"ACGTNacgt", np.uint8), (n, L))
    seq[rng.integers(0, n, n // 8), rng.integers(0, L, n // 8)] = 0xFF
    lengths = rng.integers(0, L + 1, n).astype(np.int32)
    lengths[:2] = 0
    lengths[2:4] = L
    lengths[4:6] = L + 40
    la = len(ADAPTER)
    a = np.frombuffer(ADAPTER, np.uint8)
    seq[2, L - la:] = a  # fits exactly: j + la == len == L
    seq[3, L - la + 1:] = a[:-1]  # runs past the row: no match
    for r in range(6, n, 5):
        j = int(rng.integers(0, L - la + 1))
        seq[r, j:j + la] = a | (0x20 if r % 2 else 0)  # some lower case
        lengths[r] = max(lengths[r], j + la - (r % 3 == 0))
    seq[n // 2:n // 2 + 6] = seq[6]
    lengths[n // 2:n // 2 + 6] = lengths[6]
    return seq, lengths, n if n_records is None else n_records


CASES = [(64, 128, None), (64, 128, 50), (33, 256, 33), (40, 40, 17)]


@pytest.mark.parametrize("n,L,n_records", CASES)
def test_read_hashes_bit_equal(n, L, n_records):
    jnp, _, ref_dedup = _ref()
    seq, lengths, nr = _batch(n, L, seed=n + L, n_records=n_records)
    want = np.asarray(ref_dedup.read_hashes(
        jnp.asarray(seq), jnp.asarray(lengths), jnp.int32(nr)))
    got = dedup.read_hashes(torch.from_numpy(seq), torch.from_numpy(lengths),
                            nr).numpy()
    assert got.dtype == np.int64
    assert ((got >= 0) & (got <= 0xFFFFFFFF)).all()
    np.testing.assert_array_equal(want, got.astype(np.uint32))
    assert (got[nr:] == 0xFFFFFFFF).all()  # padding rows: the sentinel
    fits = lengths[:nr] <= L
    rows = [seq[i, :lengths[i]].tobytes() for i in np.flatnonzero(fits)]
    np.testing.assert_array_equal(dedup.read_hashes_cpu(rows),
                                  got[:nr][fits].astype(np.uint32))


@pytest.mark.parametrize("adapter", [ADAPTER, b"acgt", b"N", ADAPTER * 3])
@pytest.mark.parametrize("n,L,n_records", CASES)
def test_adapter_content_equal(n, L, n_records, adapter):
    jnp, ref_ad, _ = _ref()
    seq, lengths, nr = _batch(n, L, seed=2 * n + L, n_records=n_records)
    want = ref_ad.adapter_content(jnp.asarray(seq), jnp.asarray(lengths),
                                  jnp.int32(nr), adapter_host=adapter)
    got = ad.adapter_content(torch.from_numpy(seq),
                             torch.from_numpy(lengths), nr,
                             adapter_host=adapter)
    for name, a, b in zip(want._fields, want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)
        assert b.dtype == torch.int32, name
    if adapter == ADAPTER and L >= len(ADAPTER):
        assert int(got.reads_with_adapter) > 0
        assert int(got.first_occurrence[L - len(ADAPTER)]) >= 1  # row 2


def test_adapter_longer_than_the_row():
    """The one deliberate difference: an adapter longer than the padded
    width finds no read in the port, where the reference's shifted compare
    fails to broadcast and raises."""
    jnp, ref_ad, _ = _ref()
    seq, lengths, nr = _batch(16, 40, seed=4)
    long = ADAPTER * 4
    with pytest.raises(TypeError):
        ref_ad.adapter_content(jnp.asarray(seq), jnp.asarray(lengths),
                               jnp.int32(nr), adapter_host=long)
    got = ad.adapter_content(torch.from_numpy(seq), torch.from_numpy(lengths),
                             nr, adapter_host=long)
    assert int(got.reads_with_adapter) == 0
    assert int(got.first_occurrence.sum()) == 0
    assert int(got.reads_scanned) == 16


def test_adapter_stats_merge_and_curve():
    jnp, ref_ad, _ = _ref()
    parts = []
    for seed in (1, 2):
        seq, lengths, nr = _batch(48, 128, seed=seed, n_records=40)
        parts.append((ref_ad.adapter_content(
            jnp.asarray(seq), jnp.asarray(lengths), jnp.int32(nr),
            adapter_host=ADAPTER), ad.adapter_content(
            torch.from_numpy(seq), torch.from_numpy(lengths), nr,
            adapter_host=ADAPTER)))
    want = parts[0][0].merge(parts[1][0])
    got = parts[0][1].merge(parts[1][1])
    np.testing.assert_array_equal(want.cumulative_fraction(),
                                  got.cumulative_fraction())
    host = got.to_numpy()
    for a, b in zip(want, host):
        np.testing.assert_array_equal(np.asarray(a), b)
        assert b.dtype == np.int64


def test_numpy_helpers_equal():
    _, ref_ad, ref_dedup = _ref()
    rng = np.random.default_rng(3)
    pool = [rng.choice(np.frombuffer(b"ACGT", np.uint8),
                       int(rng.integers(5, 60))).tobytes() for _ in range(40)]
    reads = [pool[int(i)] for i in rng.zipf(1.5, 3000) % len(pool)]
    reads += [b"xx" + ADAPTER.lower() + b"ACG", b"", b"\xff\xfe" * 9]
    np.testing.assert_array_equal(ref_dedup.read_hashes_cpu(reads),
                                  dedup.read_hashes_cpu(reads))
    h = dedup.read_hashes_cpu(reads)
    lv_ref, fu_ref = ref_dedup.duplication_levels(h)
    lv, fu = dedup.duplication_levels(h)
    np.testing.assert_array_equal(lv_ref, lv)
    assert fu == fu_ref
    pfx = np.zeros((len(reads), 50), np.uint8)
    for i, r in enumerate(reads):
        pfx[i, :min(50, len(r))] = np.frombuffer(r[:50], np.uint8)
    over = dedup.overrepresented_sequences(h, pfx)
    assert over and over == ref_dedup.overrepresented_sequences(h, pfx)
    assert dedup.duplication_levels(np.empty((0, 2), np.uint32))[1] == 1.0
    assert dedup.overrepresented_sequences(np.empty((0, 2), np.uint32),
                                           pfx[:0]) == []
    for max_len in (None, 20):
        assert ad.adapter_content_cpu(reads, ADAPTER, max_len) == \
            ref_ad.adapter_content_cpu(reads, ADAPTER, max_len)


@pytest.mark.parametrize("n,L,n_records", CASES)
def test_hashes_and_adapters_on_card(n, L, n_records):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    seq, lengths, nr = _batch(n, L, seed=n * L, n_records=n_records)
    cpu = (torch.from_numpy(seq), torch.from_numpy(lengths))
    gpu = tuple(t.cuda() for t in cpu)
    assert torch.equal(dedup.read_hashes(*gpu, nr).cpu(),
                       dedup.read_hashes(*cpu, nr))
    for a, b in zip(ad.adapter_content(*gpu, nr, adapter_host=ADAPTER),
                    ad.adapter_content(*cpu, nr, adapter_host=ADAPTER)):
        assert torch.equal(a.cpu(), b)


# ------------------------------------------- the sample in run_file

DUP_BATCH = 4096
# 0, under one batch, a cut inside the first batch, exactly one and two
# batches, and more than the file holds (DUP_READS)
DUP_LIMITS = [0, 1, 700, DUP_BATCH, 2 * DUP_BATCH, 20_000]
DUP_READS = 9_000
_DUP_REFERENCE = {}


@pytest.fixture(scope="module")
def dup_file(tmp_path_factory):
    """DUP_READS reads of 30-160 bp over three batches of DUP_BATCH (some
    longer than the 128 width), every 9th read a copy of one of seven
    templates, so the sample holds duplicates and overrepresented reads."""
    import blazeseq_tpu_torch as bt

    lines = bytes(bt.generate_synthetic_fastq_buffer(
        DUP_READS, 30, 160, 2, 40, "sanger")).split(b"\n")
    for r in range(8, DUP_READS, 9):
        t = r % 7
        lines[4 * r + 1] = lines[4 * t + 1]
        lines[4 * r + 3] = lines[4 * t + 3]
    path = tmp_path_factory.mktemp("dups") / "dups.fastq"
    path.write_bytes(b"\n".join(lines))
    return str(path)


def _dup_kw(limit):
    return dict(quality_schema="sanger", batch_size=DUP_BATCH,
                max_read_len=128, track_duplicates=True,
                dup_track_limit=limit)


def _same_dup_report(port, ref, limit):
    assert port.to_dict() == ref.to_dict()
    np.testing.assert_array_equal(np.asarray(ref.duplication_levels),
                                  port.duplication_levels)
    assert port.frac_unique_reads == ref.frac_unique_reads
    assert port.overrepresented == ref.overrepresented
    assert port.reads == DUP_READS
    sampled = min(limit, DUP_READS)
    levels = np.asarray(port.duplication_levels)
    assert (levels.sum() > 0) == (sampled > 0)
    if sampled >= DUP_BATCH:
        assert port.overrepresented  # the seven templates


@pytest.mark.parametrize("sample_batches", [64, 1])
@pytest.mark.parametrize("limit", DUP_LIMITS)
def test_run_file_dup_track_limit_matches_reference(dup_file, limit,
                                                    sample_batches,
                                                    monkeypatch):
    """QCModel.run_file's duplication panel (one sample buffer, hashed
    into at the rows seen so far) equals the reference's for every limit;
    with room for one batch at the start, the sample doubles as it
    fills."""
    models = pytest.importorskip("blazeseq_tpu.models")
    from blazeseq_tpu_torch.models import qc as qc_mod

    if limit not in _DUP_REFERENCE:
        _DUP_REFERENCE[limit] = models.QCModel(**_dup_kw(limit)).run_file(
            dup_file)
    monkeypatch.setattr(qc_mod, "_DUP_SAMPLE_BATCHES", sample_batches)
    port = qc_mod.QCModel(device="cpu", **_dup_kw(limit)).run_file(dup_file)
    _same_dup_report(port, _DUP_REFERENCE[limit], limit)


@pytest.mark.parametrize("limit,sizes", [
    (20_000, [4096, 4096, 8192, 16384, 16384, 20000]),
    (5000, [4096, 4096, 5000]),
    (300, [300])])
def test_dup_sample_doubles_when_full(monkeypatch, limit, sizes):
    """The sample is made for min(limit, _DUP_SAMPLE_BATCHES batches) rows,
    kept while it has room and doubled (up to the limit) when full."""
    from blazeseq_tpu_torch.models import qc as qc_mod

    monkeypatch.setattr(qc_mod, "_DUP_SAMPLE_BATCHES", 1)
    model = qc_mod.QCModel(device="cpu", **_dup_kw(limit))
    buf, got = None, []
    needs = [300, 4096, 4500, 9000, 16000, 20000][:len(sizes)]
    for need in needs:
        grown = model._dup_room(buf, min(need, limit), torch.device("cpu"))
        if buf is not None and grown is not buf:
            # one copy of the filled rows into the new buffer
            assert torch.equal(grown[:buf.shape[0]], buf)
        if buf is not None and grown.shape == buf.shape:
            assert grown is buf  # no new buffer while there is room
        buf = grown
        buf.fill_(len(got))
        got.append(buf.shape[0])
    assert got == sizes


@pytest.mark.parametrize("limit", DUP_LIMITS)
def test_run_file_dup_track_limit_on_card(dup_file, limit):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from blazeseq_tpu_torch import QCModel

    before = dedup.read_hashes.launches
    gpu = QCModel(device="cuda", **_dup_kw(limit)).run_file(dup_file)
    # one launch a batch that the sample reaches
    assert dedup.read_hashes.launches - before == -(
        -min(limit, DUP_READS) // DUP_BATCH)
    _same_dup_report(gpu, QCModel(device="cpu", **_dup_kw(limit)).run_file(
        dup_file), limit)
