"""Parity: the PyTorch port's padded-batch panels (ops/stats.py::qc_stats,
ops/adapter.py::adapter_content and _adapter_contents,
ops/dedup.py::read_hashes) against the reference's jitted functions in
blazeseq_tpu/ops/{stats,adapter,dedup}.py.

The edge set: widths 1, 7, 16, 33 and 256 (and 1024 for the hashes);
lengths 0, up to L and past it up to 2L + 1 (and negative for the hashes); n_records 0, n and in between; Phred offsets 33 and 64 with
quality bytes below the offset and above offset + 63; col_offset 5 and
error_codes None; lowercase bases, 0x00, space and high-bit bytes; an
adapter of one byte, one planted so that it fits only at the last column,
and a 12-mer. Every leaf is an integer: np.array_equal, no tolerance.

The running totals: qc_stats(out=) over 1, 2 and 5 batches equals the sum
of the reference's per batch, and _adapter_contents (every adapter of a
list at once: none, one, FastQC's six, one longer than the row, one in
lower case) equals the reference per adapter, with and without out=; an
out of another shape, or of loose leaves, raises; QCModel's device totals
give the same report whatever their flush period.

The duplication sample: _read_hashes_into writes the reference's first
`rows` hashes into rows [at, at + rows) of a larger buffer and nothing
else, and refuses rows or buffers that do not fit.

On the CPU the dispatchers run their plain torch versions and count no
launch. The card cases hold each CUDA kernel (csrc/qc_stats.cu,
csrc/adapter.cu, csrc/dedup.cu) against its plain version on the same
CUDA tensors, on the edge set and at the host route's shapes ([4096, 256],
[32768, 1024] with the [64, L] quartile leaf); they skip where there is no
CUDA device or no nvcc.
"""

import numpy as np
import pytest
import torch

from blazeseq_tpu_torch.ops import adapter as ad
from blazeseq_tpu_torch.ops import dedup
from blazeseq_tpu_torch.ops import stats

WIDTHS = [1, 7, 16, 33, 256]
# (label, n_records, with error codes, col_offset); n_records None is n
RECORDS = [("all", None, True, 0), ("some", "mid", False, 5),
           ("none", 0, True, 0)]
# (count_scalars, row_stats, qual_hist_2d)
OPTIONS = [(True, True, False), (False, True, False), (True, False, False),
           (True, True, True)]
ADAPTER = b"AGATCGGAAGAG"
# FastQC's adapter list
FASTQC_ADAPTERS = (b"AGATCGGAAGAG", b"TGGAATTCTCGG", b"GATCGTCGGACT",
                   b"CTGTCTCTTATA", b"AAAAAAAAAAAA", b"GGGGGGGGGGGG")
# (label, adapters): none, one, FastQC's six, and the six with one longer
# than the widest row below and one in lower case
ADAPTER_SETS = [("none", ()), ("one", (ADAPTER,)), ("fastqc", FASTQC_ADAPTERS),
                ("mixed", FASTQC_ADAPTERS + (b"ACGT" * 70, b"tggaattctcgg"))]
N_ROWS = 37


def _ref():
    """jax.numpy and the reference modules, imported per test so that the
    card cases also run where only the port is installed."""
    jnp = pytest.importorskip("jax.numpy")
    from blazeseq_tpu.ops import adapter as ref_ad
    from blazeseq_tpu.ops import dedup as ref_dedup
    from blazeseq_tpu.ops import stats as ref_stats

    return jnp, ref_stats, ref_ad, ref_dedup


def _batch(n, L, seed, offset=33):
    """seq, qual u8[n, L], lengths i32[n] and codes i32[n] with the edge
    set's bytes and lengths."""
    rng = np.random.default_rng(seed)
    seq = rng.choice(np.frombuffer(b"ACGTNacgtn", np.uint8), (n, L))
    k = max(2, n * L // 12)
    seq.flat[rng.integers(0, n * L, k)] = rng.choice(
        np.array([0x00, 0x20, 0x80, 0xC3, 0xE7, 0xFF], np.uint8), k)
    qual = rng.integers(offset, offset + 64, (n, L)).astype(np.uint8)
    qual.flat[rng.integers(0, n * L, k)] = rng.choice(
        np.array([0, offset - 1, offset, offset + 63, offset + 64, 0xFF],
                 np.uint8), k)
    lengths = rng.integers(0, 2 * L + 2, n).astype(np.int32)
    lengths[: n // 2] = rng.integers(0, L + 1, n // 2)
    lengths[:4] = (0, L, L + 1, 2 * L + 1)
    codes = rng.choice(np.array([0, 0, 0, 4, 5], np.int32), n)
    return seq, qual, lengths, codes


def _n_records(spec, n):
    return n // 2 + 1 if spec == "mid" else spec


def _same_leaves(want, got, label):
    for name, w, g in zip(want._fields, want, got):
        if w is None or g is None:
            assert w is None and g is None, (label, name)
            continue
        assert g.dtype == torch.int32, (label, name)
        np.testing.assert_array_equal(np.asarray(w), g.cpu().numpy(),
                                      err_msg="%s: %s" % (label, name))


@pytest.mark.parametrize("offset", [33, 64])
@pytest.mark.parametrize("records", RECORDS, ids=[r[0] for r in RECORDS])
@pytest.mark.parametrize("options", OPTIONS,
                         ids=["default", "no_scalars", "no_rows", "2d"])
@pytest.mark.parametrize("L", WIDTHS)
def test_qc_stats_equals_reference(L, options, records, offset):
    jnp, ref_stats, _, _ = _ref()
    label, spec, with_codes, col_offset = records
    count_scalars, row_stats, qh2d = options
    seq, qual, lengths, codes = _batch(N_ROWS, L, seed=L * 7 + offset,
                                       offset=offset)
    nr = _n_records(spec, N_ROWS)
    kw = dict(col_offset=col_offset, count_scalars=count_scalars,
              row_stats=row_stats, qual_hist_2d=qh2d)
    want = ref_stats.qc_stats(
        jnp.asarray(seq), jnp.asarray(qual), jnp.asarray(lengths), offset,
        n_records=None if nr is None else jnp.int32(nr),
        error_codes=jnp.asarray(codes) if with_codes else None, **kw)
    before = stats.qc_stats.launches
    t = [torch.from_numpy(a) for a in (seq, qual, lengths, codes)]
    for fn in (stats.qc_stats, stats.qc_stats_torch):
        got = fn(t[0], t[1], t[2], offset, n_records=nr,
                 error_codes=t[3] if with_codes else None, **kw)
        _same_leaves(want, got, "%s %s" % (fn.__name__, label))
    assert stats.qc_stats.launches == before  # no kernel on the CPU
    if count_scalars and row_stats and nr != 0 and L >= 16:
        # the edge set reaches the panels it is for
        assert int(got.length_hist.sum()) > 0
        assert int(got.base_counts[4]) > 0  # N, 0x00 and high bits
        assert int(got.qual_hist[0]) > 0 and int(got.qual_hist[63]) > 0


def _adapter_batch(n, L, adapter, seed):
    """seq and lengths from _batch with `adapter` planted: in some rows
    (some lower case), and at the last column of a row of length L, where
    it fits only there; one copy runs one byte past the row."""
    seq, _, lengths, _ = _batch(n, L, seed)
    rng = np.random.default_rng(seed + 1)
    a = np.frombuffer(adapter, np.uint8)
    la = len(a)
    if la <= L:
        seq[1, L - la:] = a  # lengths[1] == L: j + la == len == L
        seq[5, L - la + 1:] = a[:-1]  # the match would end past the row
        for r in range(6, n, 3):
            j = int(rng.integers(0, L - la + 1))
            seq[r, j:j + la] = a | (0x20 if r % 2 else 0)
    return seq, lengths


@pytest.mark.parametrize("records", RECORDS[:3], ids=[r[0] for r in RECORDS])
@pytest.mark.parametrize("adapter", [b"C", ADAPTER, b"last"],
                         ids=["one_byte", "12mer", "last_column"])
@pytest.mark.parametrize("L", WIDTHS)
def test_adapter_content_equals_reference(L, adapter, records):
    jnp, _, ref_ad, _ = _ref()
    _, spec, _, _ = records
    last = adapter == b"last"
    if last:
        # a 5-mer (or the whole row) that only row 1's last columns hold
        adapter = bytes(b"TTGCA"[: min(5, L)])
    seq, lengths = _adapter_batch(N_ROWS, L, adapter, seed=3 * L)
    nr = _n_records(spec, N_ROWS)
    t = (torch.from_numpy(seq), torch.from_numpy(lengths))
    before = ad.adapter_content.launches
    got = [fn(*t, nr, adapter_host=adapter)
           for fn in (ad.adapter_content, ad.adapter_content_torch)]
    assert ad.adapter_content.launches == before
    if len(adapter) > L:
        # the recorded difference: the reference raises, the port finds
        # nothing
        for g in got:
            assert int(g.reads_with_adapter) == 0
            assert int(g.first_occurrence.sum()) == 0
        return
    want = ref_ad.adapter_content(
        jnp.asarray(seq), jnp.asarray(lengths),
        None if nr is None else jnp.int32(nr), adapter_host=adapter)
    for g in got:
        for name, w, x in zip(want._fields, want, g):
            assert x.dtype == torch.int32, name
            np.testing.assert_array_equal(np.asarray(w), x.numpy(),
                                          err_msg=name)
    if nr != 0:
        assert int(got[0].reads_with_adapter) > 0
    if last and nr != 0:
        assert int(got[0].first_occurrence[L - len(adapter)]) >= 1


@pytest.mark.parametrize("records", RECORDS[:3], ids=[r[0] for r in RECORDS])
@pytest.mark.parametrize("L", WIDTHS)
def test_read_hashes_equal_reference(L, records):
    jnp, _, _, ref_dedup = _ref()
    _, spec, _, _ = records
    seq, _, lengths, _ = _batch(N_ROWS, L, seed=5 * L)
    seq[N_ROWS - 6:] = seq[4]  # duplicated rows
    lengths[N_ROWS - 6:] = lengths[4]
    nr = _n_records(spec, N_ROWS)
    want = np.asarray(ref_dedup.read_hashes(
        jnp.asarray(seq), jnp.asarray(lengths),
        None if nr is None else jnp.int32(nr)))
    t = (torch.from_numpy(seq), torch.from_numpy(lengths))
    before = dedup.read_hashes.launches
    for fn in (dedup.read_hashes, dedup.read_hashes_torch):
        got = fn(*t, nr).numpy()
        assert got.dtype == np.int64
        assert ((got >= 0) & (got <= 0xFFFFFFFF)).all()
        np.testing.assert_array_equal(want, got.astype(np.uint32))
    assert dedup.read_hashes.launches == before


# the hash kernel's edge widths: one piece a row, pieces cut by L % 16, 16
# lanes a row, and 32 lanes with two pieces each
HASH_WIDTHS = WIDTHS + [1024]
# (label, rows hashed): every row, a cut in the middle, one row
HASH_ROWS = [("all", N_ROWS), ("cut", N_ROWS // 2 + 3), ("one", 1)]


@pytest.mark.parametrize("at", [0, 11])
@pytest.mark.parametrize("rows", HASH_ROWS, ids=[r[0] for r in HASH_ROWS])
@pytest.mark.parametrize("records", RECORDS, ids=[r[0] for r in RECORDS])
@pytest.mark.parametrize("L", HASH_WIDTHS)
def test_read_hashes_into_equals_reference(L, records, rows, at):
    """_read_hashes_into (the plain branch) writes the reference's first
    `rows` hashes into out[at:at + rows] of a larger buffer and leaves the
    rest alone; lengths 0, L, L + 1, 2L + 1 and negative, n_records n, in
    between and 0, duplicated rows."""
    jnp, _, _, ref_dedup = _ref()
    _, spec, _, _ = records
    _, take = rows
    seq, _, lengths, _ = _batch(N_ROWS, L, seed=3 * L + 1)
    lengths[4:6] = (-1, -L - 7)
    seq[N_ROWS - 6:] = seq[6]  # duplicated rows
    lengths[N_ROWS - 6:] = lengths[6]
    nr = _n_records(spec, N_ROWS)
    want = np.asarray(ref_dedup.read_hashes(
        jnp.asarray(seq), jnp.asarray(lengths),
        None if nr is None else jnp.int32(nr)))[:take]
    out = torch.full((at + take + 5, 2), -5, dtype=torch.int64)
    before = dedup.read_hashes.launches
    assert dedup._read_hashes_into(torch.from_numpy(seq),
                                   torch.from_numpy(lengths), nr, out, at,
                                   take) is None
    assert dedup.read_hashes.launches == before
    got = out.numpy()
    assert ((got[at:at + take] >= 0)
            & (got[at:at + take] <= 0xFFFFFFFF)).all()
    np.testing.assert_array_equal(want, got[at:at + take].astype(np.uint32))
    assert (got[:at] == -5).all() and (got[at + take:] == -5).all()


def test_read_hashes_into_refusals():
    seq = torch.zeros((6, 16), dtype=torch.uint8)
    lengths = torch.full((6,), 9, dtype=torch.int32)
    out = torch.zeros((8, 2), dtype=torch.int64)
    for kw, msg in [
            (dict(rows=7), "7 rows of a batch of 6"),
            (dict(rows=-1), "-1 rows"),
            (dict(at=3, rows=6), r"rows \[3, 9\) outside out's 8"),
            (dict(at=-1), r"rows \[-1, 5\)"),
            (dict(out=out.to(torch.int32)), "contiguous int64"),
            (dict(out=torch.zeros((8, 3), dtype=torch.int64)),
             "contiguous int64"),
            (dict(out=torch.zeros((2, 8), dtype=torch.int64).t()),
             "contiguous int64"),
            (dict(out=torch.zeros((8, 2), dtype=torch.int64,
                                  device="meta")), "out on meta")]:
        args = dict(out=out, at=0, rows=6)
        args.update(kw)
        with pytest.raises(ValueError, match=msg):
            dedup._read_hashes_into(seq, lengths, None, args["out"],
                                    args["at"], args["rows"])
    assert (out == 0).all()
    meta = seq.to("meta")
    with pytest.raises(ValueError, match="unsupported device meta"):
        dedup._read_hashes_into(meta, lengths.to("meta"), None,
                                out.to("meta"), 0, 6)


def _ref_qc_stats(ref_stats, jnp, seq, qual, lengths, codes, offset, nr,
                  **kw):
    return ref_stats.qc_stats(
        jnp.asarray(seq), jnp.asarray(qual), jnp.asarray(lengths), offset,
        n_records=None if nr is None else jnp.int32(nr),
        error_codes=None if codes is None else jnp.asarray(codes), **kw)


@pytest.mark.parametrize("with_codes", [True, False],
                         ids=["codes", "no_codes"])
@pytest.mark.parametrize("options", OPTIONS,
                         ids=["default", "no_scalars", "no_rows", "2d"])
@pytest.mark.parametrize("n_batches", [1, 2, 5])
def test_qc_stats_out_adds_batches(n_batches, options, with_codes):
    """qc_stats(out=) over batches of different n_records (one width)
    equals, leaf for leaf, the sum of the reference's qc_stats per batch;
    the leaves are views of one buffer, and to_numpy copies it whole."""
    jnp, ref_stats, _, _ = _ref()
    count_scalars, row_stats, qh2d = options
    kw = dict(count_scalars=count_scalars, row_stats=row_stats,
              qual_hist_2d=qh2d)
    L = 33
    want = total = None
    for b in range(n_batches):
        seq, qual, lengths, codes = _batch(N_ROWS, L, seed=100 + b)
        codes = codes if with_codes else None
        nr = (None, N_ROWS // 2 + 1, 0, N_ROWS - 3, 5)[b]
        part = _ref_qc_stats(ref_stats, jnp, seq, qual, lengths, codes, 33,
                             nr, **kw)
        part = [None if x is None else np.asarray(x, np.int64) for x in part]
        want = part if want is None else [
            None if w is None else w + x for w, x in zip(want, part)]
        t = [None if a is None else torch.from_numpy(a)
             for a in (seq, qual, lengths, codes)]
        got = stats.qc_stats(t[0], t[1], t[2], 33, n_records=nr,
                             error_codes=t[3], out=total, **kw)
        assert total is None or got is total  # added in place
        total = got
    assert stats._flat_buffer(total) is not None
    _same_leaves(stats.QCStats(*want), total, "%d batches" % n_batches)
    for w, h in zip(want, total.to_numpy()):
        assert (w is None) == (h is None)
        if w is not None:
            assert h.dtype == np.int64
            np.testing.assert_array_equal(w, h)


def test_qc_stats_out_refuses_other_layouts():
    seq, qual, lengths, _ = _batch(N_ROWS, 16, seed=1)
    t = [torch.from_numpy(a) for a in (seq, qual, lengths)]
    total = stats.qc_stats(*t, 33)
    wide = stats.qc_stats(*(torch.from_numpy(a) for a in _batch(
        N_ROWS, 17, seed=1)[:3]), 33)
    with pytest.raises(ValueError, match="columns wide"):
        stats.qc_stats(*t, 33, out=wide)
    with pytest.raises(ValueError, match=r"lacks the \[64, L\] leaf"):
        stats.qc_stats(*t, 33, qual_hist_2d=True, out=total)
    with pytest.raises(ValueError, match=r"has the \[64, L\] leaf"):
        stats.qc_stats(*t, 33, out=stats.qc_stats(*t, 33, qual_hist_2d=True))
    loose = [stats.qc_stats_torch(*t, 33), total.merge(total),
             stats.QCStats(*(None if a is None else a.clone()
                             for a in total))]
    for out in loose:
        with pytest.raises(ValueError, match="views of one int32 buffer"):
            stats.qc_stats(*t, 33, out=out)
    with pytest.raises(ValueError, match="must be a QCStats"):
        stats.qc_stats(*t, 33, out=tuple(total))
    before = [a.clone() for a in total if a is not None]
    assert stats.qc_stats(*t, 33, out=total) is total
    for a, b in zip(before, (x for x in total if x is not None)):
        assert torch.equal(2 * a, b)


def _multi_adapter_batch(n, L, adapters, seed):
    """seq and lengths from _batch with each adapter planted in rows of
    its own (every other copy in lower case) where it fits, the first of
    them as long as the row."""
    seq, _, lengths, _ = _batch(n, L, seed)
    rng = np.random.default_rng(seed + 1)
    for k, adapter in enumerate(adapters):
        a = np.frombuffer(adapter, np.uint8)
        if not 0 < len(a) <= L:
            continue
        rows = range(4 + k, n, len(adapters))
        lengths[rows[0]] = L
        for r in rows:
            j = int(rng.integers(0, L - len(a) + 1))
            seq[r, j:j + len(a)] = a | (0x20 if r % 2 else 0)
    return seq, lengths


def _ref_adapter(ref_ad, jnp, seq, lengths, nr, adapter):
    """The reference's AdapterStats as int64 arrays; an adapter longer than
    the row (which the reference refuses) finds nothing, as in the port."""
    n, L = seq.shape
    if len(adapter) > L:
        return [np.zeros(L, np.int64), np.int64(0),
                np.int64(n if nr is None else nr)]
    st = ref_ad.adapter_content(jnp.asarray(seq), jnp.asarray(lengths),
                                None if nr is None else jnp.int32(nr),
                                adapter_host=adapter)
    return [np.asarray(x, np.int64) for x in st]


@pytest.mark.parametrize("with_out", [False, True], ids=["new", "out"])
@pytest.mark.parametrize("adapters", ADAPTER_SETS,
                         ids=[a[0] for a in ADAPTER_SETS])
@pytest.mark.parametrize("L", [33, 256])
def test_adapter_contents_equal_reference(L, adapters, with_out):
    """Every adapter of a list in one call equals the reference per
    adapter; with out=, two batches add into one buffer."""
    jnp, _, ref_ad, _ = _ref()
    _, adapters = adapters
    batches = [(None, 11), (N_ROWS // 2, 12)] if with_out else [(None, 11)]
    want = [None] * len(adapters)
    total = None
    for nr, seed in batches:
        seq, lengths = _multi_adapter_batch(N_ROWS, L, adapters, seed)
        for k, a in enumerate(adapters):
            part = _ref_adapter(ref_ad, jnp, seq, lengths, nr, a)
            want[k] = part if want[k] is None else [
                w + x for w, x in zip(want[k], part)]
        t = (torch.from_numpy(seq), torch.from_numpy(lengths))
        before = ad.adapter_content.launches
        got = ad._adapter_contents(*t, nr, adapters, out=total)
        assert ad.adapter_content.launches == before
        assert total is None or got is total
        total = got
    assert len(total) == len(adapters)
    for k, (w, g) in enumerate(zip(want, total)):
        for name, x, y in zip(ad.AdapterStats._fields, w, g):
            assert y.dtype == torch.int32
            np.testing.assert_array_equal(x, y.numpy(), err_msg="%d %s"
                                          % (k, name))
    if len(adapters) >= 6:
        assert all(int(g.reads_with_adapter) > 0 for g in total[:6])


def test_adapter_contents_out_refuses_other_shapes():
    seq, lengths = _multi_adapter_batch(N_ROWS, 33, FASTQC_ADAPTERS, 3)
    t = (torch.from_numpy(seq), torch.from_numpy(lengths))
    total = ad._adapter_contents(*t, None, FASTQC_ADAPTERS)
    with pytest.raises(ValueError, match="must hold 5 AdapterStats"):
        ad._adapter_contents(*t, None, FASTQC_ADAPTERS[:5], out=total)
    narrow = ad._adapter_contents(t[0][:, :32].contiguous(), t[1], None,
                                  FASTQC_ADAPTERS)
    with pytest.raises(ValueError, match=r"views of one int32 \[6, 35\]"):
        ad._adapter_contents(*t, None, FASTQC_ADAPTERS, out=narrow)
    loose = tuple(ad.adapter_content(*t, adapter_host=a)
                  for a in FASTQC_ADAPTERS)
    with pytest.raises(ValueError, match="views of one int32"):
        ad._adapter_contents(*t, None, FASTQC_ADAPTERS, out=loose)
    assert ad._adapter_contents(*t, None, (), out=()) == ()


def test_device_totals_flush_period_keeps_reports(monkeypatch):
    """run_file and the host route (_host_consume) add every batch into a
    device total that goes to the host every _FLUSH_EVERY batches: the
    report is the same whatever the period."""
    import blazeseq_tpu_torch as bt
    from blazeseq_tpu_torch.models import qc as qc_mod

    raw = bytes(bt.generate_synthetic_fastq_buffer(300, 20, 90, 2, 40,
                                                   "sanger"))
    kw = dict(quality_schema="sanger", batch_size=16, max_read_len=128,
              adapters=list(FASTQC_ADAPTERS[:2]), track_quartiles=True,
              device="cpu")
    reports = []
    for every in (64, 3, 1):
        monkeypatch.setattr(qc_mod, "_FLUSH_EVERY", every)
        model = qc_mod.QCModel(**kw)
        rep = model.run_reader(bt.MemoryReader(raw))
        host = qc_mod.QCModel(quality_schema="sanger", batch_size=16,
                              max_read_len=128, device="cpu")
        acc = stats.QCAccumulator()
        host._host_consume(host._parser(bt.MemoryReader(raw)), acc)
        assert host.tier_chunks["host"] == 19
        reports.append((rep.to_dict(), host._report_from_acc(acc).to_dict()))
    assert reports[0][0]["reads"] == 300
    assert reports[1:] == reports[:1] * 2
    assert reports[0][1]["reads"] == 300


@pytest.mark.parametrize("L", [1, 100, 256])
@pytest.mark.parametrize("qh2d", [False, True])
def test_kernel_buffer_layout_is_the_leaves(L, qh2d):
    """The kernel's one output buffer holds the leaves in QCStats' field
    order, at the plain version's shapes."""
    seq, qual, lengths, _ = _batch(5, L, seed=L)
    got = stats.qc_stats_torch(torch.from_numpy(seq), torch.from_numpy(qual),
                               torch.from_numpy(lengths), 33,
                               qual_hist_2d=qh2d)
    layout = stats._layout(L, qh2d)
    assert len(layout) == len(stats.QCStats._fields)
    for name, leaf, (shape, size) in zip(stats.QCStats._fields, got, layout):
        assert (leaf is None) == (shape is None) == (size == 0), name
        if leaf is not None:
            assert tuple(leaf.shape) == shape and leaf.numel() == size, name


def _calls(seq, qual, lengths):
    """(name, dispatcher, call) of the three panels on one batch."""
    return [
        ("qc_stats", stats.qc_stats,
         lambda: stats.qc_stats(seq, qual, lengths, 33)),
        ("adapter_content", ad.adapter_content,
         lambda: ad.adapter_content(seq, lengths, adapter_host=ADAPTER)),
        ("read_hashes", dedup.read_hashes,
         lambda: dedup.read_hashes(seq, lengths)),
    ]


@pytest.mark.parametrize("which", range(3))
def test_dispatch_refuses_other_devices(which):
    t = torch.zeros((4, 16), dtype=torch.uint8, device="meta")
    lengths = torch.zeros(4, dtype=torch.int32, device="meta")
    name, fn, call = _calls(t, t, lengths)[which]
    before = fn.launches
    with pytest.raises(ValueError, match="%s: unsupported device" % name):
        call()
    assert fn.launches == before


class _LooksCuda(torch.Tensor):
    """A CPU tensor that reports is_cuda, to reach the CUDA branch's checks
    without a card."""

    @property
    def is_cuda(self):
        return True


def _bad_batches(make):
    """(label, seq, qual, lengths, error, message) of batches every CUDA
    branch refuses; `make` turns a numpy array into a tensor."""
    u8 = np.zeros((4, 32), np.uint8)
    i32 = np.full(4, 10, np.int32)
    s, ln = make(u8), make(i32)
    return [
        ("seq dtype", make(u8.astype(np.int32)), s, ln, TypeError,
         "seq must be torch.uint8"),
        ("lengths dtype", s, s, make(i32.astype(np.int64)), TypeError,
         "lengths must be torch.int32"),
        ("seq not contiguous", make(np.zeros((32, 4), np.uint8)).t(), s, ln,
         ValueError, "seq must be contiguous"),
        ("seq rank", make(u8.reshape(-1)), make(u8.reshape(-1)), ln,
         ValueError, r"must (both )?be \[n, L\]"),
        ("lengths shape", s, s, make(np.full(3, 10, np.int32)), ValueError,
         r"lengths must be \[n\]"),
    ]


@pytest.mark.parametrize("which", range(3))
def test_cuda_branch_refuses_bad_batches_before_loading(which, monkeypatch):
    from blazeseq_tpu_torch import _kernels

    def must_not_load():
        raise AssertionError("kernel library loaded for a refused batch")

    monkeypatch.setattr(_kernels, "load", must_not_load)
    for label, seq, qual, lengths, err, msg in _bad_batches(
            lambda a: torch.Tensor._make_subclass(_LooksCuda,
                                                  torch.from_numpy(a))):
        name, fn, call = _calls(seq, qual, lengths)[which]
        before = fn.launches
        with pytest.raises(err, match=msg):
            call()
        assert fn.launches == before, label


def test_qc_stats_refuses_bad_codes_before_loading(monkeypatch):
    from blazeseq_tpu_torch import _kernels

    monkeypatch.setattr(_kernels, "load", lambda: None)

    def looks(a):
        return torch.Tensor._make_subclass(_LooksCuda, torch.from_numpy(a))

    u8 = looks(np.zeros((4, 32), np.uint8))
    ln = looks(np.full(4, 10, np.int32))
    with pytest.raises(TypeError, match="error_codes must be torch.int32"):
        stats.qc_stats(u8, u8, ln, 33,
                       error_codes=looks(np.zeros(4, np.int64)))
    with pytest.raises(ValueError, match=r"error_codes must be \[n\]"):
        stats.qc_stats(u8, u8, ln, 33,
                       error_codes=looks(np.zeros(5, np.int32)))


# ------------------------------------------------------------ on the card

@pytest.fixture
def card():
    """Skip without a CUDA device or without nvcc: the kernels have no CPU
    mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from blazeseq_tpu_torch import _kernels

    try:
        _kernels.find_nvcc()
    except RuntimeError as e:
        pytest.skip("needs nvcc to build the kernels: %s" % e)
    _kernels.load()


def _on_card(a, misaligned=False):
    """`a` on the card; with `misaligned`, as a contiguous view one byte
    into its storage (the kernels' byte path)."""
    if not misaligned:
        return torch.from_numpy(a).cuda()
    flat = torch.empty(a.size + 1, dtype=torch.uint8, device="cuda")
    flat[1:].copy_(torch.from_numpy(a.reshape(-1)))
    return flat[1:].view(a.shape)


# the edge widths, the host route's batches, and a batch tall enough that
# qc_stats' blocks take their most rows (512)
CARD_SHAPES = [(N_ROWS, L) for L in WIDTHS] + [(300, 1024), (4096, 256),
                                               (32768, 1024), (300000, 16)]


@pytest.mark.parametrize("n,L", CARD_SHAPES)
def test_qc_stats_kernel_on_card(card, n, L):
    """Every option set, n_records 0 / n / in between, offsets 33 and 64,
    col_offset 0 and 5, with and without codes; aligned rows and rows one
    byte off alignment."""
    for offset in (33, 64):
        seq, qual, lengths, codes = _batch(n, L, seed=n + L + offset,
                                           offset=offset)
        dlen, dcodes = _on_card(lengths), _on_card(codes)
        for misaligned in (False, True):
            dseq = _on_card(seq, misaligned)
            dqual = _on_card(qual, misaligned)
            for spec, with_codes, col_offset in ((None, True, 0),
                                                 ("mid", False, 5),
                                                 (0, True, 0)):
                nr = _n_records(spec, n)
                for cs, rs, qh2d in OPTIONS:
                    kw = dict(n_records=nr, col_offset=col_offset,
                              error_codes=dcodes if with_codes else None,
                              count_scalars=cs, row_stats=rs,
                              qual_hist_2d=qh2d)
                    before = stats.qc_stats.launches
                    got = stats.qc_stats(dseq, dqual, dlen, offset, **kw)
                    want = stats.qc_stats_torch(dseq, dqual, dlen, offset,
                                                **kw)
                    torch.cuda.synchronize()
                    assert stats.qc_stats.launches == before + 1
                    for name, g, w in zip(want._fields, got, want):
                        assert (g is None) == (w is None), name
                        if g is not None:
                            assert g.is_cuda and g.dtype == torch.int32
                            assert torch.equal(g, w), (name, offset, spec,
                                                       misaligned, cs, rs,
                                                       qh2d)


@pytest.mark.parametrize("n,L", CARD_SHAPES)
def test_adapter_and_hash_kernels_on_card(card, n, L):
    for adapter in (b"C", ADAPTER, bytes(b"TTGCA"[: min(5, L)]), b""):
        seq, lengths = _adapter_batch(n, L, adapter or b"A", seed=n * L)
        dlen = _on_card(lengths)
        for misaligned in (False, True):
            dseq = _on_card(seq, misaligned)
            for spec in (None, "mid", 0):
                nr = _n_records(spec, n)
                before = ad.adapter_content.launches
                got = ad.adapter_content(dseq, dlen, nr, adapter_host=adapter)
                want = ad.adapter_content_torch(dseq, dlen, nr,
                                                adapter_host=adapter)
                torch.cuda.synchronize()
                assert ad.adapter_content.launches == before + 1
                for name, g, w in zip(want._fields, got, want):
                    assert torch.equal(g, w), (name, adapter, spec)
                before = dedup.read_hashes.launches
                got = dedup.read_hashes(dseq, dlen, nr)
                want = dedup.read_hashes_torch(dseq, dlen, nr)
                torch.cuda.synchronize()
                assert dedup.read_hashes.launches == before + 1
                assert torch.equal(got, want), (spec, misaligned)


@pytest.mark.parametrize("n,L", CARD_SHAPES)
def test_read_hashes_into_kernel_on_card(card, n, L):
    """_read_hashes_into on the card equals read_hashes_torch's first rows:
    rows aligned and off 16-byte alignment, negative lengths, n_records n,
    in between and 0, every row, a cut and one row, at 0 and 11 into a
    larger buffer, whose other rows stay as they were."""
    seq, _, lengths, _ = _batch(n, L, seed=n + 3 * L)
    lengths[4:6] = (-1, -L - 7)
    dlen = _on_card(lengths)
    for misaligned in (False, True):
        dseq = _on_card(seq, misaligned)
        for spec in (None, "mid", 0):
            nr = _n_records(spec, n)
            full = dedup.read_hashes_torch(dseq, dlen, nr)
            for rows in (n, n // 2 + 3, 1):
                for at in (0, 11):
                    out = torch.full((at + rows + 5, 2), -5,
                                     dtype=torch.int64, device="cuda")
                    before = dedup.read_hashes.launches
                    dedup._read_hashes_into(dseq, dlen, nr, out, at, rows)
                    torch.cuda.synchronize()
                    assert dedup.read_hashes.launches == before + 1
                    assert torch.equal(out[at:at + rows], full[:rows]), (
                        misaligned, spec, rows, at)
                    assert (out[:at] == -5).all()
                    assert (out[at + rows:] == -5).all()


@pytest.mark.parametrize("n,L", CARD_SHAPES)
def test_qc_stats_out_on_card(card, n, L):
    """Three batches (n_records n, in between, 0 rows off alignment) added
    into one out equal the sum of the plain version's leaves, for every
    option set, with and without codes."""
    batches = []
    for b, (spec, misaligned) in enumerate(((None, False), ("mid", True),
                                            (0, False))):
        seq, qual, lengths, codes = _batch(n, L, seed=7 * n + L + b)
        batches.append((_on_card(seq, misaligned), _on_card(qual, misaligned),
                        _on_card(lengths), _on_card(codes),
                        _n_records(spec, n)))
    for with_codes in (True, False):
        for cs, rs, qh2d in OPTIONS:
            kw = dict(count_scalars=cs, row_stats=rs, qual_hist_2d=qh2d)
            total = want = None
            for dseq, dqual, dlen, dcodes, nr in batches:
                codes = dcodes if with_codes else None
                before = stats.qc_stats.launches
                total = stats.qc_stats(dseq, dqual, dlen, 33, n_records=nr,
                                       error_codes=codes, out=total, **kw)
                assert stats.qc_stats.launches == before + 1
                part = stats.qc_stats_torch(dseq, dqual, dlen, 33,
                                            n_records=nr, error_codes=codes,
                                            **kw)
                want = part if want is None else want.merge(part)
            torch.cuda.synchronize()
            for name, g, w in zip(want._fields, total, want):
                assert (g is None) == (w is None), name
                if g is not None:
                    assert torch.equal(g, w), (name, with_codes, cs, rs, qh2d)
            assert all(x.is_cuda for x in total if x is not None)
            host = total.to_numpy()
            for g, w in zip(host, want):
                if w is not None:
                    np.testing.assert_array_equal(g, w.cpu().numpy())


@pytest.mark.parametrize("adapters", ADAPTER_SETS,
                         ids=[a[0] for a in ADAPTER_SETS])
@pytest.mark.parametrize("n,L", CARD_SHAPES)
def test_adapter_contents_kernel_on_card(card, n, L, adapters):
    """Every adapter of a list in one launch equals adapter_content_torch
    per adapter, rows aligned and off alignment, n_records n / in between /
    0, then the three batches added into one out."""
    _, adapters = adapters
    seq, lengths = _multi_adapter_batch(n, L, adapters, seed=n + L)
    dlen = _on_card(lengths)
    total, want = None, [None] * len(adapters)
    for misaligned in (False, True):
        dseq = _on_card(seq, misaligned)
        for spec in (None, "mid", 0):
            nr = _n_records(spec, n)
            plain = [ad.adapter_content_torch(dseq, dlen, nr, adapter_host=a)
                     for a in adapters]
            before = ad.adapter_content.launches
            got = ad._adapter_contents(dseq, dlen, nr, adapters)
            torch.cuda.synchronize()
            assert ad.adapter_content.launches == before + bool(adapters)
            assert len(got) == len(adapters)
            for k, (g, w) in enumerate(zip(got, plain)):
                for name, x, y in zip(w._fields, g, w):
                    assert torch.equal(x, y), (k, name, spec, misaligned)
            total = ad._adapter_contents(dseq, dlen, nr, adapters, out=total)
            want = [w if t is None else t.merge(w)
                    for t, w in zip(want, plain)]
    torch.cuda.synchronize()
    for g, w in zip(total, want):
        for x, y in zip(g, w):
            assert torch.equal(x, y)


def test_empty_batch_on_card(card):
    """n = 0: zeros (and the reads count) without a launch."""
    seq = torch.zeros((0, 64), dtype=torch.uint8, device="cuda")
    lengths = torch.zeros(0, dtype=torch.int32, device="cuda")
    launches = [f.launches for _, f, _ in _calls(seq, seq, lengths)]
    st = stats.qc_stats(seq, seq, lengths, 33, qual_hist_2d=True)
    want = stats.qc_stats_torch(seq, seq, lengths, 33, qual_hist_2d=True)
    for g, w in zip(st, want):
        assert torch.equal(g, w)
    assert dedup.read_hashes(seq, lengths).shape == (0, 2)
    assert [f.launches for _, f, _ in _calls(seq, seq, lengths)][::2] \
        == launches[::2]


def test_kernels_refuse_bad_batches_on_card(card):
    for which in range(3):
        for label, seq, qual, lengths, err, msg in _bad_batches(
                lambda a: torch.from_numpy(a).cuda()):
            name, fn, call = _calls(seq, qual, lengths)[which]
            before = fn.launches
            with pytest.raises(err, match=msg):
                call()
            assert fn.launches == before, label
