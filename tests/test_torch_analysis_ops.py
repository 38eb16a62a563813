"""Parity: the PyTorch port's analysis ops against the reference's
uniform_parse, trim, kmer, tiles, demux and merge (blazeseq_tpu/ops/).

The same seeded numpy inputs (batches up to 256 x 256) go through the
reference function and the port's; every integer leaf must be equal
(np.array_equal), and the float32 per-tile sums equal as well (both hold
exact integers). The reference tests' own cases are mirrored, and the
scalar host twins are checked too. Cases named *on_card* rerun the port on
a CUDA card against its CPU result and skip where there is none.
"""

import importlib
import random

import numpy as np
import pytest
import torch

import blazeseq_tpu as bt
from blazeseq_tpu_torch.ops import demux, kmer, merge, tiles, trim


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel worker processes: keep this module's
    torch CPU ops on one thread so they do not crowd the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# the package exports the function uniform_parse under the module's name
up = importlib.import_module("blazeseq_tpu_torch.ops.uniform_parse")


def _jnp():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    return jnp


def _eq(port, ref):
    """Leaf-by-leaf equality; NamedTuples and plain tuples alike."""
    if not isinstance(port, (tuple, list)):
        port, ref = (port,), (ref,)
    assert len(port) == len(ref)
    for i, (p, r) in enumerate(zip(port, ref)):
        r = np.asarray(r)
        p = p.cpu().numpy() if isinstance(p, torch.Tensor) else np.asarray(p)
        assert p.shape == r.shape, (i, p.shape, r.shape)
        assert p.dtype == r.dtype, (i, p.dtype, r.dtype)
        np.testing.assert_array_equal(p, r, err_msg=str(i))


def _t(a):
    return torch.from_numpy(np.array(a))


def _mk(n_reads, read_len):
    return bytes(bt.generate_synthetic_fastq_buffer(
        n_reads, read_len, read_len, 2, 40, "sanger"))


# ------------------------------------------------------------ uniform_parse

def _both_uniform(buf, n_valid=None, width=128, pad_rows=0, **kw):
    jnp = _jnp()
    from blazeseq_tpu.ops.uniform_parse import uniform_parse as ref_parse

    lay = up.detect_uniform_layout(buf)
    arr = np.frombuffer(buf, np.uint8)
    pad = (-len(arr)) % lay.rs + pad_rows * lay.rs
    arr = np.concatenate([arr, np.zeros(pad, np.uint8)])
    if n_valid is None:
        n_valid = len(buf) - len(buf) % lay.rs
    args = dict(rs=lay.rs, o1=lay.o1, o2=lay.o2, o3=lay.o3, width=width,
                **kw)
    got = up.uniform_parse(_t(arr), n_valid, 33, 126, **args)
    want = ref_parse(jnp.asarray(arr), jnp.int32(n_valid), jnp.int32(33),
                     jnp.int32(126), **args)
    _eq(got, want)
    return lay, got


def _mutated(buf, kind):
    lay = up.detect_uniform_layout(buf)
    b = bytearray(buf)
    pos = dict(marker=17 * lay.rs, newline=11 * lay.rs + lay.o1,
               quality=9 * lay.rs + lay.o3 + 2,
               ascii=5 * lay.rs + lay.o1 + 3)[kind]
    b[pos] = dict(marker=ord("X"), newline=ord("A"), quality=0x20,
                  ascii=0xC8)[kind]
    return bytes(b)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("kind", ["clean", "marker", "newline", "quality",
                                  "ascii"])
def test_uniform_parse_matches_reference(kind, fused):
    buf = _mk(200, 60)
    if kind != "clean":
        buf = _mutated(buf, kind)
    _, got = _both_uniform(buf, width=64, fused_checks=fused)
    assert bool(got.template_ok) == (
        kind == "clean" or (not fused and kind in ("quality", "ascii")))
    if fused:
        assert not bool(got.bad_ascii) and not bool(got.bad_quality)
    else:
        assert bool(got.bad_quality) == (kind == "quality")
        assert bool(got.bad_ascii) == (kind == "ascii")


@pytest.mark.parametrize("check_ascii,check_quality",
                         [(False, True), (True, False), (False, False)])
def test_uniform_parse_check_flags(check_ascii, check_quality):
    for kind in ("quality", "ascii"):
        for fused in (False, True):
            _both_uniform(_mutated(_mk(200, 60), kind), width=64,
                          check_ascii=check_ascii,
                          check_quality=check_quality, fused_checks=fused)


def test_uniform_parse_zero_padded_tail_and_host_parity():
    buf = _mk(37, 60)
    _, got = _both_uniform(buf, width=64, pad_rows=10)
    assert int(got.n_records) == 37 and got.lengths[37:].sum() == 0
    pb = bt.FastqParser(bt.MemoryReader(buf)).next_padded(37, max_len=64)
    np.testing.assert_array_equal(got.seq[:37].numpy(), pb.seq[:37])
    np.testing.assert_array_equal(got.qual[:37].numpy(), pb.qual[:37])


def test_uniform_parse_clamped_width_and_violation_past_n_valid():
    buf = _mk(64, 150)
    lay, got = _both_uniform(buf, width=128)
    assert int(got.lengths[0]) == 150 and bool(got.template_ok)
    bad = bytearray(buf)
    bad[60 * lay.rs] = ord("#")  # a bad marker past n_valid
    _, got = _both_uniform(bytes(bad), n_valid=50 * lay.rs, width=128)
    assert bool(got.template_ok) and int(got.n_records) == 50


def test_uniform_parse_accepts_tensor_n_valid():
    buf = _mk(20, 40)
    lay = up.detect_uniform_layout(buf)
    args = dict(rs=lay.rs, o1=lay.o1, o2=lay.o2, o3=lay.o3, width=64)
    a = up.uniform_parse(_t(np.frombuffer(buf, np.uint8)), len(buf), 33, 126,
                         **args)
    b = up.uniform_parse(_t(np.frombuffer(buf, np.uint8)),
                         torch.tensor(len(buf), dtype=torch.int32), 33, 126,
                         **args)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# ------------------------------------------------------------------- trim

def _random_qual_batch(seed, n=64, L=128):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, L + 1, n).astype(np.int32)
    lens[:2] = 0
    lens[2:4] = L
    lens[4] = L + 50  # longer than the row: clipped to the width
    qual = rng.integers(33, 75, (n, L)).astype(np.uint8)
    qual[rng.integers(0, n, 40), rng.integers(0, L, 40)] = 20  # < offset
    quals = [qual[i, :min(int(lens[i]), L)].tobytes() for i in range(n)]
    return qual, lens, quals


TRIM_PARAMS = [
    ("clip_ends", dict(leading=10, trailing=12)),
    ("clip_ends", dict(leading=3, trailing=3)),
    ("sliding_window_trim", dict(mean_q=25, window=4)),
    ("sliding_window_trim", dict(mean_q=15, window=7)),
    ("bwa_trim", dict(threshold=20)),
    ("bwa_trim", dict(threshold=35)),
]


@pytest.mark.parametrize("fn,kw", TRIM_PARAMS)
def test_trim_matches_reference_and_twin(fn, kw):
    jnp = _jnp()
    from blazeseq_tpu.ops import trim as ref_trim

    qual, lens, quals = _random_qual_batch(22)
    got = getattr(trim, fn)(_t(qual), _t(lens), 33, **kw)
    ref_kw = {k: (v if k == "window" else jnp.int32(v))
              for k, v in kw.items()}
    want = getattr(ref_trim, fn)(jnp.asarray(qual), jnp.asarray(lens),
                                 jnp.int32(33), **ref_kw)
    _eq(got, want)
    twin = getattr(trim, fn + "_cpu")
    twin_kw = dict(kw)
    if fn == "sliding_window_trim":
        twin_kw = dict(mean_q=kw["mean_q"], window=kw["window"])
    for i, q in enumerate(quals):
        t = twin(q, 33, **twin_kw)
        g = (tuple(int(x[i]) for x in got) if fn == "clip_ends"
             else int(got[i]))
        assert g == t, i


def test_trim_known_cases():
    qual = _t(np.array([[2, 2, 30, 30, 30, 30, 2, 2]], np.uint8))
    lens = _t(np.array([8], np.int32))
    s, m = trim.clip_ends(qual, lens, 0, 3, 3)
    assert (int(s[0]), int(m[0])) == (2, 4)
    assert int(trim.sliding_window_trim(qual, lens, 0, 20, window=4)[0]) == 0
    assert int(trim.bwa_trim(qual, lens, 0, 10)[0]) == 6


def test_bwa_trim_ties_keep_the_longer_read():
    # d = 20 - q: +10, -10, +10 -> s(k) from the 3' end: 10, 0, 10; the max
    # 10 is reached at k=0 and k=2, and k=2 keeps more bases
    qual = _t(np.array([[10, 30, 10]], np.uint8))
    got = trim.bwa_trim(qual, _t(np.array([3], np.int32)), 0, 20)
    assert int(got[0]) == 2 == trim.bwa_trim_cpu(bytes([10, 30, 10]), 0, 20)


# ------------------------------------------------------------------- kmer

def _kmer_batch(seed=31, n=40, L=48):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, L + 1, n).astype(np.int32)
    lens[0] = L + 9  # past the width: windows stop at the row's end
    seq = np.zeros((n, L), np.uint8)
    reads = []
    for i in range(n):
        k = min(int(lens[i]), L)
        r = rng.choice(list(b"ACGTNacgt"), k).astype(np.uint8)
        seq[i, :k] = r
        reads.append(r.tobytes())
    return seq, lens, reads


@pytest.mark.parametrize("k", [1, 3, 5, 8])
def test_kmer_counts_match_reference_and_twin(k):
    jnp = _jnp()
    from blazeseq_tpu.ops.kmer import kmer_counts as ref_kmer

    seq, lens, reads = _kmer_batch()
    got = kmer.kmer_counts(_t(seq), _t(lens), 40, k=k)
    want = ref_kmer(jnp.asarray(seq), jnp.asarray(lens), jnp.int32(40), k=k)
    _eq(got, want)
    assert got.tolist() == kmer.kmer_counts_cpu(reads, k=k).tolist()


def test_kmer_counts_row_mask_and_default():
    jnp = _jnp()
    from blazeseq_tpu.ops.kmer import kmer_counts as ref_kmer

    seq, lens, reads = _kmer_batch(seed=4, n=16)
    got = kmer.kmer_counts(_t(seq), _t(lens), 5, k=2)
    _eq(got, ref_kmer(jnp.asarray(seq), jnp.asarray(lens), jnp.int32(5),
                      k=2))
    assert got.tolist() == kmer.kmer_counts_cpu(reads[:5], k=2).tolist()
    _eq(kmer.kmer_counts(_t(seq), _t(lens), k=2),
        ref_kmer(jnp.asarray(seq), jnp.asarray(lens), k=2))


@pytest.mark.parametrize("k", [0, 9])
def test_kmer_counts_refuse_k(k):
    with pytest.raises(ValueError, match="1..8"):
        kmer.kmer_counts(torch.zeros((2, 8), dtype=torch.uint8),
                         torch.zeros(2, dtype=torch.int32), k=k)


# ------------------------------------------------------------------ tiles

def _tile_corpus(n=400, L=50, tiles_=(1101, 1102, 2201), seed=5):
    rng = random.Random(seed)
    recs = []
    for i in range(n):
        t = rng.choice(tiles_)
        ident = b"SIM:1:FCX:1:%d:%d:%d 1:N:0:5" % (t, i, i * 7)
        if i % 37 == 0:
            ident = b"plain_read_%d" % i  # not Illumina-shaped
        ln = rng.randrange(1, L + 1)
        seq = bytes(rng.choice(b"ACGT") for _ in range(ln))
        qual = bytes(rng.randrange(20, 110) for _ in range(ln))
        recs.append(b"@" + ident + b"\n" + seq + b"\n+\n" + qual + b"\n")
    return b"".join(recs)


def test_tile_parsing_matches_reference():
    from blazeseq_tpu.ops.tiles import parse_illumina_tiles as ref_parse

    batch = bt.FastqParser(bt.MemoryReader(_tile_corpus())).next_batch(1000)
    got = tiles.parse_illumina_tiles(batch._id_bytes, batch._id_ends)
    _eq(got, ref_parse(batch._id_bytes, batch._id_ends))
    assert (got == -1).sum() == 11 and set(got.tolist()) == {
        -1, 1101, 1102, 2201}


@pytest.mark.parametrize("n_records", [None, 100])
def test_per_tile_sums_match_reference(n_records):
    from blazeseq_tpu.ops.tiles import per_tile_qual_sums as ref_sums

    batch = bt.FastqParser(bt.MemoryReader(_tile_corpus())).next_batch(256)
    pb = batch.to_padded(max_len=64)
    t = tiles.parse_illumina_tiles(batch._id_bytes, batch._id_ends)
    got = tiles.per_tile_qual_sums(t, _t(pb.qual), _t(pb.lengths), 33,
                                   n_records=n_records)
    want = ref_sums(t, pb.qual, pb.lengths, 33, n_records=n_records)
    _eq(got, want)
    # numpy inputs run on the CPU
    _eq(tiles.per_tile_qual_sums(t, pb.qual, pb.lengths, 33,
                                 n_records=n_records), want)


def test_per_tile_sums_without_known_tiles():
    from blazeseq_tpu.ops.tiles import per_tile_qual_sums as ref_sums

    t = np.full(4, -1, np.int32)
    qual = np.full((4, 128), 60, np.uint8)
    lens = np.array([3, 0, 128, 200], np.int32)
    _eq(tiles.per_tile_qual_sums(t, qual, lens, 33),
        ref_sums(t, qual, lens, 33))


def test_accumulator_matches_reference():
    from blazeseq_tpu.ops.tiles import PerTileAccumulator as RefAcc

    acc, ref = tiles.PerTileAccumulator(), RefAcc()
    parser = bt.FastqParser(bt.MemoryReader(_tile_corpus(n=600)))
    for batch in parser.batches(128):
        pb = batch.to_padded()  # widths vary batch to batch
        t = tiles.parse_illumina_tiles(batch._id_bytes, batch._id_ends)
        acc.add_batch(t, _t(pb.qual), _t(pb.lengths), 33,
                      n_records=pb.n_records)
        ref.add_batch(t, pb.qual, pb.lengths, 33, n_records=pb.n_records)
    for mine, theirs in ((acc.mean(), ref.mean()),
                         (acc.deviation(), ref.deviation())):
        np.testing.assert_array_equal(mine[0], theirs[0])
        np.testing.assert_array_equal(mine[1], theirs[1])  # NaNs included
    assert acc.tiles == ref.tiles


def test_accumulator_varying_widths():
    acc = tiles.PerTileAccumulator()
    t = np.asarray([2101], np.int32)
    acc.add_batch(t, np.full((1, 128), ord("I"), np.uint8),
                  np.asarray([100], np.int32), 33)
    acc.add_batch(t, np.full((1, 256), ord("5"), np.uint8),
                  np.asarray([200], np.int32), 33)
    ts, mean = acc.mean()
    assert list(ts) == [2101] and mean.shape[1] == 256
    assert mean[0, 0] == 30.0 and mean[0, 150] == 20.0
    assert abs(float(acc.deviation()[1][0, 0])) < 1e-12


# ------------------------------------------------------------------ demux

BARCODES = [b"ACGTAC", b"TTGGCA", b"ACGTAN", b"GGGGGG"]


def _pad(seqs, L):
    out = np.zeros((len(seqs), L), dtype=np.uint8)
    lens = np.zeros(len(seqs), dtype=np.int32)
    for i, s in enumerate(seqs):
        out[i, :len(s)] = np.frombuffer(s, dtype=np.uint8)
        lens[i] = len(s)
    return out, lens


def _demux_reads(seed=7, n=256):
    rng = random.Random(seed)
    seqs = []
    for _ in range(n):
        k = rng.randrange(len(BARCODES) + 1)
        if k < len(BARCODES):
            bc = bytearray(BARCODES[k].replace(b"N", b"A"))
            for _ in range(rng.randrange(0, 3)):
                bc[rng.randrange(len(bc))] = rng.choice(b"ACGTNacgt")
            prefix = bytes(bc)
        else:
            prefix = bytes(rng.choice(b"ACGT") for _ in range(6))
        tail = bytes(rng.choice(b"ACGT") for _ in range(rng.randrange(0, 40)))
        seqs.append((prefix + tail)[:rng.choice([3, 6, 200])])
    return seqs


@pytest.mark.parametrize("max_mm", [0, 1, 2])
def test_demux_assign_matches_reference_and_twin(max_mm):
    from blazeseq_tpu.ops.demux import demux_assign as ref_assign

    seqs = _demux_reads()
    seq, lens = _pad(seqs, 64)
    got = demux.demux_assign(_t(seq), _t(lens), BARCODES, max_mm)
    _eq(got, ref_assign(seq, lens, BARCODES, max_mm))
    assert got[0].tolist() == demux.demux_assign_host(seqs, BARCODES, max_mm)
    # a read that matches ACGTAC also matches ACGTAN: sample 0 ties with 2
    if max_mm:
        assert set(got[0].tolist()) == {-1, 1, 2, 3}


def test_demux_wildcard_and_short_reads():
    seq, lens = _pad([b"ACGTAAXXXX", b"ACGT", b"TTGGCAyyyy", b"ggggggC",
                      b"acgtac"], 32)
    a = demux.demux_assign(_t(seq), _t(lens), BARCODES, 0)[0]
    # ACGTAC ties with the wildcard barcode ACGTAN
    assert a.tolist() == [2, -1, 1, 3, -1]
    with pytest.raises(ValueError, match="narrower"):
        demux.demux_assign(_t(seq[:, :4]), _t(lens), BARCODES)
    with pytest.raises(ValueError, match="one length"):
        demux.demux_assign(_t(seq), _t(lens), [b"AC", b"ACG"])


def test_demultiplex_counts_match_reference():
    from blazeseq_tpu.ops.demux import demultiplex_counts as ref_counts

    a = np.array([0, 1, -1, 3, 3, -1, 2, 0, 0], np.int32)
    got = demux.demultiplex_counts(_t(a), 4)
    _eq(got, ref_counts(a, 4))
    assert got.tolist() == [3, 1, 1, 2, 2]


def _demux_fastq():
    recs = []
    for i, bc in enumerate(BARCODES):
        for j in range(3):
            s = bc.replace(b"N", b"G") + b"ACGTACGT"
            recs.append(b"@r%d_%d\n%s\n+\n%s\n" % (i, j, s, b"I" * len(s)))
    recs.append(b"@junk\nCCCCCCCCCCCCCC\n+\nIIIIIIIIIIIIII\n")
    recs.append(b"@exact\nTTGGCA\n+\nIIIIII\n")
    return b"".join(recs)


@pytest.mark.parametrize("trim_barcode", [False, True])
def test_demultiplex_to_writers_matches_reference(trim_barcode):
    from blazeseq_tpu.ops.demux import demultiplex_to_writers as ref_split

    def run(fn, **kw):
        outs = [bt.MemoryWriter() for _ in BARCODES]
        un = bt.MemoryWriter()
        bufs = [bt.BufferedWriter(w) for w in outs + [un]]
        totals = fn(bt.FastqParser(bt.MemoryReader(_demux_fastq())),
                    BARCODES, bufs[:-1], unassigned_writer=bufs[-1],
                    max_mismatches=1, batch_records=5,
                    trim_barcode=trim_barcode, **kw)
        for b in bufs:
            b.flush()
        return totals, [w.getvalue() for w in outs + [un]]

    got = run(demux.demultiplex_to_writers, device="cpu")
    assert got == run(ref_split)
    assert sum(got[0]) == 14 and got[0][-1] >= 1


def test_demultiplex_to_writers_refuses_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        demux.demultiplex_to_writers(
            bt.FastqParser(bt.MemoryReader(_demux_fastq())), BARCODES,
            [None] * 4)


# ------------------------------------------------------------------ merge

def _pairs(seed=11, n=120):
    rng = random.Random(seed)
    r1, r2 = [], []
    for _ in range(n):
        frag_len = rng.randrange(40, 90)
        frag = bytes(rng.choice(b"ACGT") for _ in range(frag_len))
        rl = rng.randrange(30, 60)
        s1 = bytearray(frag[:rl])
        s2 = merge._revcomp_b(frag[max(0, frag_len - rl):])
        if rng.random() < 0.3:  # a sequencing error inside the read
            s1[rng.randrange(len(s1))] = rng.choice(b"ACGTN")
        q1 = bytes(rng.randrange(35, 74) for _ in range(len(s1)))
        q2 = bytes(rng.randrange(35, 74) for _ in range(len(s2)))
        r1.append((bytes(s1), q1))
        r2.append((s2, q2))
    return r1, r2


def _merge_inputs(r1, r2, L=64):
    seq1, len1 = _pad([a for a, _ in r1], L)
    qual1, _ = _pad([b for _, b in r1], L)
    seq2, len2 = _pad([a for a, _ in r2], L)
    qual2, _ = _pad([b for _, b in r2], L)
    return seq1, qual1, len1, seq2, qual2, len2


@pytest.mark.parametrize("kw", [dict(min_overlap=10), dict(min_overlap=4),
                                dict(min_overlap=20, mismatch_penalty=3,
                                     max_mismatch_frac=0.05)])
def test_merge_matches_reference_and_twin(kw):
    from blazeseq_tpu.ops.merge import merge_pairs as ref_merge

    r1, r2 = _pairs()
    arrays = _merge_inputs(r1, r2)
    got = merge.merge_pairs(*map(_t, arrays), **kw)
    _eq(got, ref_merge(*arrays, **kw))
    host = merge.merge_pairs_host(r1, r2, **kw)
    n_merged = 0
    for i, (o, ms, mq) in enumerate(host):
        assert int(got.overlap[i]) == o, i
        ml = int(got.merged_len[i])
        assert got.seq[i, :ml].numpy().tobytes() == ms, i
        assert got.qual[i, :ml].numpy().tobytes() == mq, i
        n_merged += o > 0
    assert n_merged > 40


def test_merge_ties_keep_the_smallest_overlap():
    """A periodic read overlaps its mate at several lengths with one
    score; the smallest o wins, as in the reference."""
    from blazeseq_tpu.ops.merge import merge_pairs as ref_merge

    s1 = b"ACACACACACACACAC"
    s2 = merge._revcomp_b(b"ACACACACACACACAC")
    r1, r2 = [(s1, b"I" * 16)], [(s2, b"5" * 16)]
    arrays = _merge_inputs(r1, r2, L=32)
    got = merge.merge_pairs(*map(_t, arrays), min_overlap=4)
    _eq(got, ref_merge(*arrays, min_overlap=4))
    assert int(got.overlap[0]) == merge.merge_pairs_host(
        r1, r2, min_overlap=4)[0][0]


def test_merge_consensus_and_rejection():
    rng = random.Random(3)
    frag = bytes(rng.choice(b"ACGT") for _ in range(24))
    s1, s2 = frag[:16], merge._revcomp_b(frag[8:])
    wrong = b"A" if s1[10:11] != b"A" else b"C"
    s1 = s1[:10] + wrong + s1[11:]
    q1 = bytes([70] * 10 + [35] + [70] * 5)
    arrays = _merge_inputs([(s1, q1)], [(s2, bytes([70] * len(s2)))], L=32)
    got = merge.merge_pairs(*map(_t, arrays), min_overlap=4)
    assert int(got.overlap[0]) == 8
    assert got.seq[0, :int(got.merged_len[0])].numpy().tobytes() == frag
    assert got.seq.shape == (1, 64)
    arrays = _merge_inputs([(b"A" * 20, b"I" * 20)], [(b"C" * 20, b"I" * 20)],
                           L=32)
    got = merge.merge_pairs(*map(_t, arrays), min_overlap=10)
    assert int(got.overlap[0]) == 0 and int(got.merged_len[0]) == 0


# ------------------------------------------------------------ on the card

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _same(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x.cpu(), y)


def test_analysis_ops_on_card_match_cpu():
    _needs_card()
    qual, lens, _ = _random_qual_batch(9, n=256, L=256)
    for fn, kw in TRIM_PARAMS:
        g = getattr(trim, fn)(_t(qual).cuda(), _t(lens).cuda(), 33, **kw)
        c = getattr(trim, fn)(_t(qual), _t(lens), 33, **kw)
        _same(g if isinstance(g, tuple) else (g,),
              c if isinstance(c, tuple) else (c,))
    seq, klens, _ = _kmer_batch(n=256, L=256)
    for k in (4, 8):
        _same((kmer.kmer_counts(_t(seq).cuda(), _t(klens).cuda(), k=k),),
              (kmer.kmer_counts(_t(seq), _t(klens), k=k),))
    seq, dlens = _pad(_demux_reads(n=256), 256)
    _same(demux.demux_assign(_t(seq).cuda(), _t(dlens).cuda(), BARCODES),
          demux.demux_assign(_t(seq), _t(dlens), BARCODES))
    arrays = _merge_inputs(*_pairs(n=256))
    _same(merge.merge_pairs(*(_t(a).cuda() for a in arrays)),
          merge.merge_pairs(*map(_t, arrays)))
    t = np.random.default_rng(1).choice([1101, 1102, -1], 256).astype(
        np.int32)
    for x, y in zip(tiles.per_tile_qual_sums(t, _t(qual).cuda(),
                                             _t(lens).cuda(), 33),
                    tiles.per_tile_qual_sums(t, qual, lens, 33)):
        np.testing.assert_array_equal(x, y)
    buf = _mutated(_mk(200, 60), "quality")
    lay = up.detect_uniform_layout(buf)
    args = dict(rs=lay.rs, o1=lay.o1, o2=lay.o2, o3=lay.o3, width=64)
    arr = _t(np.frombuffer(buf, np.uint8))
    _same(up.uniform_parse(arr.cuda(), len(buf), 33, 126, **args),
          up.uniform_parse(arr, len(buf), 33, 126, **args))


# ------------------------------------------------------- the ops package

RENAMED = {"validate_decode_pallas": "validate_decode",
           "validate_decode_xla": "validate_decode_torch",
           "nw_scores_pallas": "nw_scores", "nw_scores_xla": "nw_scores_torch",
           "sw_scores_xla": "sw_scores",
           "nw_affine_scores_xla": "nw_affine_scores",
           "sw_affine_scores_xla": "sw_affine_scores",
           "nw_semiglobal_scores_xla": "nw_semiglobal_scores",
           "nw_semiglobal_affine_scores_xla": "nw_semiglobal_affine_scores"}
NOT_PORTED = {"use_interpret"}


def test_ops_package_exports_the_reference_names():
    import inspect

    ref = pytest.importorskip("blazeseq_tpu.ops")
    port = importlib.import_module("blazeseq_tpu_torch.ops")
    names = {n for n in dir(ref) if not n.startswith("_")
             and not inspect.ismodule(getattr(ref, n))}
    assert NOT_PORTED | set(RENAMED) <= names
    for n in sorted(names - NOT_PORTED):
        assert hasattr(port, RENAMED.get(n, n)), n
    for n in NOT_PORTED:
        assert not hasattr(port, n), n
