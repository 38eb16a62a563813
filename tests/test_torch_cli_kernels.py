"""Parity: the CLI's device ops of the port (trim's three modes,
demux_assign, the per-tile sums and kmer_counts; ops/{trim,demux,tiles,
kmer}.py) against the reference's jitted functions, every leaf with
np.array_equal, and their dispatch contract.

The cases are chip_smoke.py's CLI_OP_EDGE_CASES, made from a seed with
numpy: lengths 0, negative and over L, quality bytes below the offset,
all-low rows, bwa_trim ties, windows longer than the read, widths of 1, 3,
5, 12 and 13, 1,024 columns with windows of 33, 100 and 1,024 bases,
2,176 and 1,500 columns (rows the kernel takes in rounds of 1,024
columns) with windows across the rounds' edges and wider than a round,
offsets 0, 64, 255, 256, -5 and one where byte - offset wraps in int32,
thresholds outside 0-255; N in barcodes and reads, reads shorter than the
barcode, ties, K = 1, 384 barcodes of 32 bases, an odd width with
lowercase and other bytes, barcodes of 48 bases, 4,096 barcodes of 16
bases, barcode bytes outside ACGTN; k = 1..8, n_records as an int and as a
tensor, poly-G and poly-A rows, every bin of k = 7 and 8 hit;
grouped, shuffled and unknown tiles, negative tile numbers, a tile a row
(T = n = 4,096), one tile, unknown tiles interleaved at 32,768 x 1,024. On
the CPU each op runs its plain torch version (`*_torch`) and counts no
launch; other devices raise.

The card cases (*on_card*) hold each kernel (csrc/trim.cu, demux.cu,
tiles.cu, kmer.cu) against its plain version on the same CUDA tensors, on
the edge cases and at the CLI's shapes (4,096 x 256, demux's 16,384 x 256,
the analysis path's 65,536 x 256, 32,768 x 1,024, 4,096 x 2,048), each
also 1 and 13 bytes off 16-byte alignment (kmer_counts at every k, on
random and poly-G rows; demux_assign with each set of DEMUX_CARD_SETS
and each edge case through both of its layouts), hold kmer.cu to a bin
past 2^16 windows, and show
that each trim mode, the tile sums and kmer_counts run one kernel a call
and no fill; they skip where there is no CUDA device or no nvcc.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from blazeseq_tpu_torch.ops import common, demux, kmer, tiles, trim

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_chip_smoke():
    """chip_smoke.py (numpy and the standard library at import), for the
    shared edge cases."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _load_chip_smoke()
SEED = 0
OPS = {"clip_ends": trim.clip_ends,
       "sliding_window_trim": trim.sliding_window_trim,
       "bwa_trim": trim.bwa_trim, "demux_assign": demux.demux_assign,
       "per_tile_qual_sums": tiles.per_tile_qual_sums,
       "kmer_counts": kmer.kmer_counts}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel worker processes: keep this module's
    torch CPU ops on one thread so they do not crowd the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _launches():
    return {k: f.launches for k, f in OPS.items()}


def _reference_calls(op, arrays, kw):
    """The reference's result for each call of CS.cli_op_calls, in order."""
    import jax.numpy as jnp

    from blazeseq_tpu.ops import demux as ref_demux
    from blazeseq_tpu.ops import kmer as ref_kmer
    from blazeseq_tpu.ops import tiles as ref_tiles
    from blazeseq_tpu.ops import trim as ref_trim

    out = []
    if op == "trim":
        q, lens = jnp.asarray(arrays["qual"]), jnp.asarray(arrays["lengths"])
        for fn, fkw in CS.trim_modes(arrays["qual"].shape[1],
                                     kw.get("modes")):
            rkw = {k: (v if k == "window" else jnp.int32(v))
                   for k, v in fkw.items()}
            r = getattr(ref_trim, fn)(q, lens, jnp.int32(kw["offset"]), **rkw)
            out.append(r if isinstance(r, tuple) else (r,))
    elif op == "demux":
        for mm in kw["max_mismatches"]:
            out.append(ref_demux.demux_assign(arrays["seq"], arrays["lengths"],
                                              kw["barcodes"], mm))
    elif op == "kmer":
        nr = kw["n_records"]
        for k in kw["ks"]:
            out.append((ref_kmer.kmer_counts(
                jnp.asarray(arrays["seq"]), jnp.asarray(arrays["lengths"]),
                None if nr is None else jnp.int32(nr), k=k),))
    else:
        out.append(ref_tiles.per_tile_qual_sums(
            arrays["tiles"], arrays["qual"], arrays["lengths"], kw["offset"],
            n_records=kw["n_records"]))
    return out


@pytest.mark.parametrize("label", CS.CLI_OP_EDGE_CASES)
def test_cli_op_case_matches_reference(label):
    pytest.importorskip("jax")
    op, arrays, kw = CS.cli_op_case(label, SEED)
    d = CS.cli_op_tensors(arrays, "cpu")
    calls = CS.cli_op_calls(op, d, kw)
    before = _launches()
    got = [f() for _, f, _ in calls]
    assert _launches() == before  # the CPU route launches nothing
    want = _reference_calls(op, arrays, kw)
    assert len(got) == len(want) == len(calls)
    for (name, _, plain), g, w in zip(calls, got, want):
        CS.same_leaves(g, tuple(np.asarray(x) for x in w), name)
        CS.same_leaves(g, plain(), name)


def test_cases_reach_their_edges():
    """The inputs hold what their labels name."""
    def case(label):
        return CS.cli_op_case(label, SEED)

    _, a, _ = case("trim: lengths 0, negative and over L")
    lens = a["lengths"]
    assert (lens == 0).any() and (lens < 0).any() and (lens > 80).any()
    _, a, _ = case("trim: bytes below the offset")
    assert (a["qual"] < 33).sum() > 1000
    _, a, kw = case("trim: bwa ties")
    got = trim.bwa_trim_torch(torch.from_numpy(a["qual"]),
                              torch.from_numpy(a["lengths"]), 33, 20)
    ties = 0
    for i, q in enumerate(a["qual"]):
        m = min(int(a["lengths"][i]), q.size)
        s = np.cumsum((20 - (q[:m].astype(int) - 33))[::-1])[::-1]
        if m and s.max() > 0 and (s == s.max()).sum() > 1:
            ties += 1
            assert int(got[i]) == int(np.flatnonzero(s == s.max())[-1])
    assert ties > 10
    _, a, _ = case("trim: windows longer than the read")
    assert (a["lengths"] < 4).any() and (a["lengths"] < 12).mean() > 0.5
    _, a, kw = case("demux: reads shorter than the barcode")
    assert (a["lengths"] < 6).sum() > 50 and (a["lengths"] < 0).any()
    _, a, kw = case("demux: ties")
    _, best = demux.demux_assign_torch(torch.from_numpy(a["seq"]),
                                       torch.from_numpy(a["lengths"]),
                                       kw["barcodes"], 1)
    assert (best.numpy()[::2] == 1).all()
    _, a, kw = case("demux: 384 barcodes of 32 bases")
    assert len(kw["barcodes"]) == 384 and b"N" in kw["barcodes"][7]
    _, a, kw = case("demux: barcodes of 48 bases")
    assert len(kw["barcodes"]) == 8 and len(kw["barcodes"][0]) == 48
    _, a, kw = case("demux: 4,096 barcodes of 16 bases")
    bcs = kw["barcodes"]
    assert len(set(bcs)) == 4096 and {len(b) for b in bcs} == {16}
    _, best = demux.demux_assign_torch(torch.from_numpy(a["seq"]),
                                       torch.from_numpy(a["lengths"]), bcs,
                                       0)
    assert (best.numpy() == 0).sum() > 50
    _, a, kw = case("demux: a barcode byte outside ACGTN")
    assert all(set(b) - set(b"ACGTN") for b in kw["barcodes"])
    got, _ = demux.demux_assign_torch(torch.from_numpy(a["seq"]),
                                      torch.from_numpy(a["lengths"]),
                                      kw["barcodes"], 2)
    assert (got.numpy() >= 0).sum() > 50
    _, a, kw = case("kmer: poly-G and poly-A rows")
    seq = a["seq"]
    assert (seq[::4] == ord("G")).all() and (seq[1::4] == ord("A")).all()
    _, a, kw = case("kmer: k = 7 and 8, every bin hit")
    for k in (7, 8):
        c = kmer.kmer_counts_torch(torch.from_numpy(a["seq"]),
                                   torch.from_numpy(a["lengths"]), k=k)
        assert bool((c > 0).all())
    _, a, kw = case("tiles: shuffled")
    t = a["tiles"]
    assert (t[1:] != t[:-1]).sum() > 50
    _, a, kw = case("kmer: n_records as a tensor")
    assert kw["tensor"] and kw["n_records"] < len(a["lengths"])
    for width in (3, 5, 13):
        _, a, _ = case("trim: L = %d" % width)
        assert a["qual"].shape[1] == width
    for off in (0, 255, 256, -5):
        _, a, kw = case("trim: offset %d" % off)
        assert kw["offset"] == off and a["qual"].max() > 200
    _, a, kw = case("trim: offset -2^31 + 100 (Phred wraps)")
    assert kw["offset"] == -(1 << 31) + 100 and kw["modes"]
    assert (a["qual"] < 100).any() and (a["qual"] >= 150).any()
    _, a, kw = case("trim: thresholds outside 0-255")
    fkws = [fkw for _, fkw in kw["modes"]]
    assert any(v < 0 for f in fkws for k, v in f.items() if k != "window")
    assert any(v > 255 for f in fkws for k, v in f.items() if k != "window")
    # the first failing windows of 33 and 100 bases fall in many of the
    # 32-column lane segments; a window as wide as the batch fits the full
    # rows
    _, a, kw = case("trim: L = 1,024, windows across lane segments")
    assert a["qual"].shape[1] == 1024 and (a["lengths"] == 1024).sum() > 20
    q, lens = torch.from_numpy(a["qual"]), torch.from_numpy(a["lengths"])
    for w in (33, 100):
        cut = trim.sliding_window_trim_torch(q, lens, 33, 20, window=w)
        assert len(np.unique(cut.numpy() // 32)) > 10
    # past 1,024 columns the rows take rounds: each mode's cuts fall in
    # both the first round and later ones, and a window is wider than a
    # round
    for label in ("trim: L = 2,176, windows across rounds",
                  "trim: L = 1,500, windows across rounds"):
        _, a, kw = case(label)
        L = a["qual"].shape[1]
        assert L == int(label.split()[3].replace(",", ""))
        assert any(f.get("window", 0) > 1024
                   for _, f in CS.trim_modes(L, kw["modes"]))
        q, lens = torch.from_numpy(a["qual"]), torch.from_numpy(a["lengths"])
        for cut in (trim.sliding_window_trim_torch(q, lens, 33, 20,
                                                   window=100),
                    trim.sliding_window_trim_torch(q, lens, 33, 22,
                                                   window=1100),
                    trim.bwa_trim_torch(q, lens, 33, 20)):
            cut = cut.numpy()
            assert (cut < 1024).sum() > 5 and (cut >= 1024).sum() > 5
    _, a, _ = case("tiles: negative tile numbers")
    t = a["tiles"]
    assert {-2, -7, -100000, -(1 << 31)} <= set(t.tolist())
    assert (t >= 0).sum() > 50
    _, a, _ = case("tiles: T = n")
    assert len(np.unique(a["tiles"])) == len(a["tiles"]) == 4096
    _, a, _ = case("tiles: every row one tile")
    assert len(np.unique(a["tiles"])) == 1
    _, a, kw = case("tiles: unknown tiles interleaved, 32,768 x 1,024")
    assert a["qual"].shape == (32768, 1024) and kw["n_records"] < 32768
    t = a["tiles"]
    assert ((t[1:] < 0) != (t[:-1] < 0)).sum() > 10000


def test_cpu_tensors_run_the_plain_versions_and_other_devices_raise():
    for label in ("trim: lengths 0, negative and over L",
                  "demux: N in barcodes and reads",
                  "kmer: n_records as a tensor",
                  "tiles: unknown tiles and n_records"):
        op, arrays, kw = CS.cli_op_case(label, SEED)
        d = CS.cli_op_tensors(arrays, "cpu")
        before = _launches()
        for name, f, plain in CS.cli_op_calls(op, d, kw):
            CS.same_leaves(f(), plain(), name)
        assert _launches() == before
    q = torch.zeros((4, 32), dtype=torch.uint8, device="meta")
    lens = torch.zeros(4, dtype=torch.int32, device="meta")
    for fn in (trim.clip_ends, trim.sliding_window_trim, trim.bwa_trim):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(q, lens, 33)
    with pytest.raises(ValueError, match="unsupported device"):
        demux.demux_assign(q, lens, [b"ACGT"])
    with pytest.raises(ValueError, match="unsupported device"):
        kmer.kmer_counts(q, lens, k=3)
    with pytest.raises(ValueError, match="unsupported device"):
        tiles.per_tile_qual_sums(np.zeros(4, np.int32), q, lens, 33)


def test_barcode_words_layout_and_cache():
    """The set as csrc/demux.cu reads it, made once a set and device: sets
    of ACGTN bytes of more than 8 barcodes or more than 16 bases as
    bit-planes of 32 positions (the codes (b >> 1) & 7 of the upper-cased
    bytes, then a mask off 'N' and past bl); any other set as bytes, four
    a word, then 0xFF masks off 'N' and past bl."""
    cpu = torch.device("cpu")
    bcs = (b"acgTN", b"GGCCA") + tuple(b"TTTT" + bytes([b])
                                       for b in b"ACGTACG")
    planes, w = demux._barcode_words(bcs, cpu)
    assert (planes, w) == demux._barcode_words(bcs, cpu)
    assert planes and w.dtype == torch.int32 and tuple(w.shape) == (9, 1, 4)
    raw = w.numpy().view(np.uint32)
    # A 0, C 1, G 3, T 2, N 7 at positions 0-4
    assert raw[0, 0].tolist() == [0b10110, 0b11100, 0b10000, 0b01111]
    # G G C C A
    assert raw[1, 0].tolist() == [0b01111, 0b00011, 0, 0b11111]
    # a 33-base barcode takes two plane words
    planes, w = demux._barcode_words((b"A" * 32 + b"T",), cpu)
    assert planes and tuple(w.shape) == (1, 2, 4)
    assert w.numpy().view(np.uint32)[0, 1].tolist() == [0, 1, 0, 1]
    # bytes: a byte outside ACGTN, barcodes over 256 bases, a small set
    for odd in ((b"acgTN", b"GGC-A"), (b"A" * 257,), (b"acgTN", b"GGCCA")):
        planes, w = demux._barcode_words(odd, cpu)
        bl = len(odd[0])
        assert not planes and tuple(w.shape) == (2, len(odd), -(-bl // 4))
    # chip_smoke's bounds count the work of the layout the set takes
    for s in (bcs, (b"acgTN", b"GGC-A"), (b"A" * 257,),
              (b"acgTN", b"GGCCA"), (b"A" * 32 + b"T",)):
        assert CS.demux_planes(s) == demux._barcode_words(s, cpu)[0], s
    # each layout of a set, as _pack_set makes it
    codes, _ = demux._prep_barcodes(bcs)
    assert (demux._pack_set(codes, True)
            == demux._barcode_words(bcs, cpu)[1].numpy()).all()
    assert demux._pack_set(codes, False).shape == (2, 9, 2)
    planes, w = demux._barcode_words((b"acgTN", b"GGC-A"), cpu)
    raw = w.numpy().view(np.uint8).reshape(2, 2, 8)
    assert raw[0, 0].tobytes() == b"ACGTN\0\0\0"
    assert raw[0, 1].tobytes() == b"GGC-A\0\0\0"
    assert raw[1, 0].tolist() == [255, 255, 255, 255, 0, 0, 0, 0]
    assert raw[1, 1].tolist() == [255] * 5 + [0] * 3


def test_tile_rows_map():
    """The host's row -> tile-row map, in file order, that the tiles kernel
    reads: unknown tiles and rows past n_records go to the dropped row."""
    t = np.array([2101, 1101, -1, 2101, 1101, 7], np.int32)
    uniq, dst, rows = tiles._tile_rows(t, 6, None, 5)
    assert uniq.tolist() == [1101, 2101] and rows == 2
    assert dst.dtype == np.int32 and dst.tolist() == [1, 0, 2, 1, 0, 2]
    # every negative tile number is unknown, as -1 is
    t = np.array([-2, 5, -7, 5, -100000, 3, -(1 << 31)], np.int32)
    uniq, dst, rows = tiles._tile_rows(t, 7, None, None)
    assert uniq.tolist() == [3, 5] and dst.tolist() == [2, 1, 2, 1, 2, 0, 2]
    uniq, dst, rows = tiles._tile_rows(np.full(3, -1, np.int32), 3, None,
                                       None)
    assert len(uniq) == 0 and rows == 1 and dst.tolist() == [1, 1, 1]


def test_tile_buffers_are_kept_and_grow():
    """The tiles kernel's scratch by name, device and stream: made zeroed
    once, reused while large enough, made anew (zeroed) when asked for
    more."""
    common._KEPT.clear()
    cpu = torch.device("cpu")
    sums = common._kept("sums", cpu, 7, 100, torch.int64)
    assert sums.dtype == torch.int64 and sums.numel() >= 100
    assert not sums.any()
    assert common._kept("sums", cpu, 7, 50, torch.int64) is sums
    assert common._kept("sums", cpu, 8, 50, torch.int64) is not sums
    assert common._kept("tickets", cpu, 7, 50, torch.int32) is not sums
    grown = common._kept("sums", cpu, 7, 150, torch.int64)
    assert grown.numel() >= 150 and not grown.any()
    common._KEPT.clear()


# ------------------------------------------------------------ on the card

@pytest.fixture
def card():
    """Skip without a CUDA device or without nvcc: the kernels have no CPU
    mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CLI ops' kernels have no CPU "
                    "mode")
    from blazeseq_tpu_torch import _kernels

    try:
        _kernels.find_nvcc()
    except RuntimeError as e:
        pytest.skip("needs nvcc to build the kernels: %s" % e)
    _kernels.load()


def _on_card(op, arrays, kw, view, label):
    d = CS.cli_op_tensors(arrays, "cuda", view)
    for name, f, plain in CS.cli_op_calls(op, d, kw):
        before = _launches()
        got = f()
        torch.cuda.synchronize()
        after = _launches()
        launched = {k: after[k] - before[k] for k in after if after[k]
                    != before[k]}
        assert list(launched.values()) in ([1], []), (name, launched)
        # a batch with no read of a known tile sums nothing on the card
        idle = not len(arrays["lengths"]) or (
            op == "tiles" and not (arrays["tiles"] >= 0).any())
        assert bool(launched) != idle, (name, launched)
        CS.same_leaves(got, plain(), "%s, %s, view %d" % (label, name, view))


@pytest.mark.parametrize("view", CS.CLI_OP_VIEW_OFFSETS)
@pytest.mark.parametrize("label", CS.CLI_OP_EDGE_CASES)
def test_cli_op_case_on_card(card, label, view):
    op, arrays, kw = CS.cli_op_case(label, SEED)
    _on_card(op, arrays, kw, view, label)


CARD_OPTIONS = dict(trim=dict(offset=33),
                    demux=dict(barcodes=CS.DEMUX_BARCODES,
                               max_mismatches=(0, 1)),
                    kmer=dict(n_records=None, ks=CS.KMER_KS),
                    tiles=dict(offset=33, n_records=None))


@pytest.mark.parametrize("view", CS.CLI_OP_VIEW_OFFSETS)
@pytest.mark.parametrize("shape", CS.CLI_OP_CARD_SHAPES)
@pytest.mark.parametrize("op", ("trim", "demux", "kmer", "tiles"))
def test_cli_op_card_shapes_on_card(card, op, shape, view):
    arrays = CS.cli_op_card_batch(op, *shape, SEED)
    _on_card(op, arrays, CARD_OPTIONS[op], view, "%s %dx%d" % ((op,) + shape))


@pytest.mark.parametrize("view", CS.CLI_OP_VIEW_OFFSETS)
@pytest.mark.parametrize("shape", CS.CLI_OP_CARD_SHAPES)
@pytest.mark.parametrize("which", range(len(CS.DEMUX_CARD_SETS)))
def test_demux_card_sets_on_card(card, which, shape, view):
    """Each barcode set of DEMUX_CARD_SETS (the CLI's 4 x 8; 8 x 48 and
    4,096 x 16, which the kernel before refused) at every card shape."""
    name, bcs, mms = CS.DEMUX_CARD_SETS[which]
    arrays = CS.cli_op_card_batch("demux", *shape, SEED, bcs)
    _on_card("demux", arrays, dict(barcodes=bcs, max_mismatches=mms), view,
             "demux %s, %dx%d" % ((name,) + shape))


@pytest.mark.parametrize("view", CS.CLI_OP_VIEW_OFFSETS)
@pytest.mark.parametrize("label", [x for x in CS.CLI_OP_EDGE_CASES
                                   if x.startswith("demux")])
def test_demux_both_layouts_on_card(card, label, view):
    """Each demux edge case through both layouts of csrc/demux.cu, where
    its set has both: the bit-planes (the default for sets of more than 8
    barcodes or more than 16 bases) and the bytes."""
    _, arrays, kw = CS.cli_op_case(label, SEED)
    d = CS.cli_op_tensors(arrays, "cuda", view)
    bcs = tuple(bytes(b) for b in kw["barcodes"])
    layouts = (False, True) if set(b"".join(bcs).upper()) <= set(b"ACGTN") \
        else (False,)
    codes, bl = demux._prep_barcodes(bcs)
    for planes in layouts:
        words = torch.from_numpy(demux._pack_set(codes, planes)).cuda()
        for mm in kw["max_mismatches"]:
            got = demux._launch(d["seq"], d["lengths"], planes, words,
                                len(bcs), bl, mm)
            CS.same_leaves(got, demux.demux_assign_torch(
                d["seq"], d["lengths"], bcs, mm), "%s, planes %s, "
                "max_mismatches %d, view %d" % (label, planes, mm, view))


def test_kmer_start_tickets_across_launches_on_card(card):
    """kmer.cu's kept start-ticket state across launches of every k and of
    one owner and many (a row count of 0 on the card among them), and
    across replays of a CUDA graph: every launch writes every bin."""
    small = CS.cli_op_tensors(CS.cli_op_card_batch("kmer", 8, 32, SEED),
                              "cuda")
    big = CS.cli_op_tensors(CS.cli_op_card_batch("kmer", 4096, 256, SEED),
                            "cuda")
    none = torch.zeros((), dtype=torch.int32, device="cuda")
    for i in range(24):
        k = i % 8 + 1
        d = (small, big)[i % 3 != 0]
        rows = none if i % 5 == 4 else None
        got = kmer.kmer_counts(d["seq"], d["lengths"], rows, k=k)
        want = kmer.kmer_counts_torch(d["seq"], d["lengths"], rows, k=k)
        CS.same_leaves((got,), (want,), "launch %d, k = %d" % (i, k))
    seq = big["seq"].clone()
    kmer.kmer_counts(seq, big["lengths"], k=8)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = kmer.kmer_counts(seq, big["lengths"], k=8)
    rng = np.random.default_rng(SEED)
    for i in range(3):
        seq.copy_(torch.from_numpy(rng.choice(
            np.frombuffer(b"ACGTN", np.uint8), tuple(seq.shape))))
        graph.replay()
        want = kmer.kmer_counts_torch(seq, big["lengths"], k=8)
        CS.same_leaves((got,), (want,), "graph replay %d" % i)


@pytest.mark.parametrize("k", CS.KMER_KS)
def test_kmer_big_batches_and_a_full_bin_on_card(card, k):
    """kmer.cu at every k on random and poly-G rows at the analysis path's
    65,536 x 256 and on poly-A rows at 4,096 x 256, where one bin takes
    more than 2^16 windows (k = 8: a cluster's blocks a bin slice each)."""
    kb = CS.cli_op_card_batch("kmer", 65536, 256, SEED)
    batches = [kb, dict(kb, seq=np.full_like(kb["seq"], ord("G"))),
               dict(seq=np.full((4096, 256), ord("A"), np.uint8),
                    lengths=np.full(4096, 256, np.int32))]
    for i, arrays in enumerate(batches):
        d = CS.cli_op_tensors(arrays, "cuda")
        want = kmer.kmer_counts_torch(d["seq"], d["lengths"], k=k)
        if i == 2:
            assert int(want.max()) > 1 << 16
        before = kmer.kmer_counts.launches
        got = kmer.kmer_counts(d["seq"], d["lengths"], k=k)
        assert kmer.kmer_counts.launches == before + 1
        CS.same_leaves((got,), (want,), "k = %d, batch %d" % (k, i))


def test_trim_and_tiles_one_kernel_no_fill_on_card(card):
    """At the CLI's shape each trim mode, the tile sums, kmer_counts and
    demux_assign run one kernel a call on the card and no fill (the tile
    sums: no host sort, no zero fill; the row map up and the sums down are
    its only copies; kmer_counts writes every bin and keeps its scratch
    zero)."""
    arrays = CS.cli_op_card_batch("tiles", 4096, 256, SEED)
    d = CS.cli_op_tensors(arrays, "cuda")
    seq = CS.cli_op_tensors(CS.cli_op_card_batch("kmer", 4096, 256, SEED),
                            "cuda")["seq"]
    calls = dict(
        kmer_counts=lambda: kmer.kmer_counts(seq, d["lengths"], k=4),
        kmer_counts_8=lambda: kmer.kmer_counts(seq, d["lengths"], k=8),
        demux_assign=lambda: demux.demux_assign(seq, d["lengths"],
                                                CS.DEMUX_BARCODES, 1),
        clip_ends=lambda: trim.clip_ends(d["qual"], d["lengths"], 33),
        sliding_window_trim=lambda: trim.sliding_window_trim(
            d["qual"], d["lengths"], 33, 15, window=4),
        bwa_trim=lambda: trim.bwa_trim(d["qual"], d["lengths"], 33, 20),
        per_tile_qual_sums=lambda: tiles.per_tile_qual_sums(
            d["tiles"], d["qual"], d["lengths"], 33))
    for name, fn in calls.items():
        kernels, fills = CS.device_work(fn)
        assert len(kernels) == 1 and not fills, (name, kernels, fills)


def test_cli_kernels_refuse_bad_batches_on_card(card):
    q = torch.full((8, 32), 60, dtype=torch.uint8, device="cuda")
    lens = torch.full((8,), 20, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="not on a CUDA device"):
        trim.bwa_trim(q, lens.cpu(), 33)
    with pytest.raises(ValueError, match="must be contiguous"):
        trim.clip_ends(q.t().contiguous().t(), lens, 33)
    with pytest.raises(ValueError, match="window"):
        trim.sliding_window_trim(q, lens, 33, window=33)
    with pytest.raises(ValueError, match="int32"):
        trim.bwa_trim(q, lens, 33, threshold=1 << 40)
    with pytest.raises(ValueError, match="narrower"):
        demux.demux_assign(q[:, :4].contiguous(), lens, [b"ACGTA"])
    with pytest.raises(ValueError, match="must be contiguous"):
        kmer.kmer_counts(q[:, ::2], lens, k=3)
    with pytest.raises(ValueError, match="one value"):
        kmer.kmer_counts(q, lens, torch.ones(2, device="cuda"), k=3)
    # lengths on the host with rows on the card raise in every op
    with pytest.raises(ValueError, match="not on a CUDA device"):
        demux.demux_assign(q, lens.cpu(), [b"ACGTA"])
    with pytest.raises(ValueError, match="not on a CUDA device"):
        tiles.per_tile_qual_sums(np.zeros(8, np.int32), q, lens.cpu(), 33)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        kmer.kmer_counts(q, lens.cpu(), k=3)
    # barcodes of more than 32 bases and sets of more than 6,144 words of 4
    # bases, which the kernel before refused, equal the plain version
    wide = torch.full((8, 64), 65, dtype=torch.uint8, device="cuda")
    for bcs in ([b"A" * 33], _barcode_set(769, 32)):
        got = demux.demux_assign(wide, lens, bcs)
        CS.same_leaves(got, demux.demux_assign_torch(wide.cpu(), lens.cpu(),
                                                     bcs),
                       "%d barcodes of %d bases" % (len(bcs), len(bcs[0])))


def _barcode_set(K, bl):
    """K distinct barcodes of bl bases (ACGT, one N in every 8th)."""
    rng = np.random.default_rng(SEED)
    codes = rng.choice(np.frombuffer(b"ACGT", np.uint8), (K, bl))
    codes[::8, bl // 2] = ord("N")
    return sorted({c.tobytes() for c in codes})[:K]


@pytest.mark.parametrize("K, bl", ((768, 32), (4096, 16)))
def test_demux_largest_set_on_card(card, K, bl):
    """768 barcodes of 32 bases (the most the kernel before held in 48 KB
    of shared memory) and 4,096 of 16 (16,384 words of 4 bases, past it)
    against the plain version; reads planted from the set with up to two
    mismatches."""
    bcs = _barcode_set(K, bl)
    assert len(bcs) == K
    rng = np.random.default_rng(SEED)
    n, L = 4096, 64
    seq = rng.choice(np.frombuffer(b"ACGTNacgt", np.uint8), (n, L))
    pick = rng.integers(0, len(bcs), n)
    planted = np.frombuffer(b"".join(bcs), np.uint8).reshape(-1, bl)[pick]
    seq[:, :bl] = np.where(planted == ord("N"), ord("A"), planted)
    for j in range(2):
        col = rng.integers(0, bl, n)
        hit = rng.random(n) < 0.4
        seq[hit, col[hit]] = ord("T") - j
    lens = rng.integers(bl - 12, L + 1, n).astype(np.int32)
    for mm in (0, 1, 2):
        before = demux.demux_assign.launches
        got = demux.demux_assign(torch.from_numpy(seq).cuda(),
                                 torch.from_numpy(lens).cuda(), bcs, mm)
        assert demux.demux_assign.launches == before + 1
        want = demux.demux_assign_torch(torch.from_numpy(seq),
                                        torch.from_numpy(lens), bcs, mm)
        CS.same_leaves(got, want, "%d barcodes of %d bases, max_mismatches "
                       "%d" % (K, bl, mm))
        assert (got[0].cpu() >= 0).any()
