"""Parity: the port's merge_pairs (blazeseq_tpu_torch/ops/merge.py) against
the reference's jitted blazeseq_tpu/ops/merge.py::merge_pairs, every
MergeResult leaf with np.array_equal.

The cases are chip_smoke.py's MERGE_EDGE_CASES, made from a seed with
numpy: lengths above L (rows from to_padded(max_len=), true lengths),
zero-length reads, min_overlap 0, -1 and above L, mismatch_penalty 0 and
3, max_mismatch_frac 0.0, 0.1 (overlaps of 10 k bases with k mismatches:
the fp32 edge) and 1.0, lowercase bases, N and other bytes, ties, L of 1,
17 and 300, n = 0, int64 lengths, R1 rows of all 256 byte values (every
code of the kernel's bit-planes against every rc(R2) letter) and ties 32
or more overlaps apart, in one lane of the kernel's order and in two. The
bytes of a row past its read are random.

On the CPU merge_pairs runs its plain torch version (merge_pairs_torch)
and counts no launch. The card cases hold the kernel (csrc/merge.cu)
against merge_pairs_torch on the same CUDA tensors, on the same cases, on
the merge command's 4,096 x 256 batch, on MiSeq mates at 4,096 x 384, on
wide rows staged by fewer warps a block and on rows too wide to stage in
shared memory; they skip where there is no CUDA device or no nvcc.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from blazeseq_tpu_torch.ops import merge

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_chip_smoke():
    """chip_smoke.py (numpy and the standard library at import), for the
    shared edge cases."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CHIP_SMOKE = _load_chip_smoke()
SEED = 0


def _case(label):
    return CHIP_SMOKE.merge_edge_case(label, SEED)


def _eq(got, want):
    assert len(got) == len(want) == 6
    for name, g, w in zip(merge.MergeResult._fields, got, want):
        g = g.cpu().numpy()
        w = w.cpu().numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        assert g.shape == w.shape, (name, g.shape, w.shape)
        assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
        assert np.array_equal(g, w), name


@pytest.mark.parametrize("label", CHIP_SMOKE.MERGE_EDGE_CASES)
def test_merge_case_matches_reference(label):
    pytest.importorskip("jax")
    from blazeseq_tpu.ops.merge import merge_pairs as ref_merge

    arrays, kw = _case(label)
    before = merge.merge_pairs.launches
    got = merge.merge_pairs(*map(torch.from_numpy, arrays), **kw)
    assert merge.merge_pairs.launches == before
    _eq(got, ref_merge(*arrays, **kw))
    n, L = arrays[0].shape
    assert got.seq.shape == (n, 2 * L)


def test_cases_reach_their_edges():
    """The cases hold what their labels say: merged and unmerged pairs,
    lengths past L, empty reads, an accepted pair at mism = o / 10 with
    frac 0.1, and ties between overlaps."""
    res = {}
    for label in CHIP_SMOKE.MERGE_EDGE_CASES:
        arrays, kw = _case(label)
        res[label] = (arrays, kw, merge.merge_pairs_torch(
            *map(torch.from_numpy, arrays), **kw))
    (s1, _, l1, _, _, l2), _, r = res["lengths above L (to_padded max_len)"]
    assert s1.shape[1] == 256 and (l1 > 256).any() and (l2 > 256).any()
    assert ((r.overlap > 0) & torch.from_numpy(l1 > 256)).any()
    (_, _, l1, _, _, l2), _, r = res["zero-length reads"]
    assert (l1 == 0).any() and (l2 == 0).any() and (r.overlap > 0).any()
    _, _, r = res["max_mismatch_frac 0.1"]
    ov, mm = r.overlap.numpy(), r.mismatches.numpy()
    assert ((ov > 0) & (10 * mm == ov) & (mm > 0)).any()
    assert (ov == 0).any()
    for label in ("planted overlaps", "mismatch_penalty 3", "L = 300",
                  "lowercase, N and other bytes"):
        ov = res[label][2].overlap
        assert (ov > 0).any() and (ov == 0).any(), label
    # ties: some pair scores as well at a larger overlap than the one kept
    arrays, kw, r = res["a tie at two overlaps"]
    rows = merge.merge_pairs_host(
        [(bytes(s[:k]), bytes(q[:k])) for s, q, k in zip(*arrays[:3])],
        [(bytes(s[:k]), bytes(q[:k])) for s, q, k in zip(*arrays[3:])],
        **kw)
    assert [o for o, _, _ in rows] == r.overlap.tolist()
    assert _tied_pairs(arrays, kw["min_overlap"]) > 0
    # every R1 row holds all 256 byte values; some pairs merge on them
    arrays, kw, r = res["every byte value in R1"]
    assert all(len(set(row.tolist())) == 256 for row in arrays[0])
    assert (r.overlap > 0).any() and (r.overlap == 0).any()
    # ties 32 or more overlaps apart, some in one lane of the kernel's
    # order (lane l scores o_lo + u and o_hi - u for u = l, l + 32, ...)
    arrays, kw, r = res["ties far apart at L = 256"]
    ties = _ties(arrays, 10)
    assert all(o == min(t) for o, t in zip(r.overlap.tolist(), ties))
    lanes = [{_lane(o, 10, hi) for o in t} for t, hi in
             zip(ties, np.minimum(arrays[2], arrays[5]))]
    assert any(len(t) > 1 and len(ln) == 1 for t, ln in zip(ties, lanes))
    assert any(len(ln) > 1 for ln in lanes)
    assert all(max(t) - min(t) >= 2 for t in ties)


def _ties(arrays, min_overlap, penalty=1):
    """Each pair's overlaps at its best score."""
    seq1, _, len1, seq2, _, len2 = arrays
    out = []
    for a, la, b, lb in zip(seq1, len1, seq2, len2):
        rc = merge._COMP[b[:lb][::-1]]
        scores = {}
        for o in range(max(min_overlap, 1), min(la, lb, len(a)) + 1):
            m = int((a[la - o:la] == rc[:o]).sum())
            scores[o] = m - penalty * (o - m)
        best = max(scores.values(), default=None)
        out.append([o for o, s in scores.items() if s == best])
    return out


def _lane(o, o_lo, o_hi):
    """The lane of csrc/merge.cu's order that scores overlap o."""
    u = o - o_lo if 2 * (o - o_lo) <= o_hi - o_lo else o_hi - o
    return u % 32


def _tied_pairs(arrays, min_overlap):
    """Pairs whose best score is reached at two overlaps or more."""
    return sum(len(t) > 1 for t in _ties(arrays, min_overlap))


def test_cpu_route_counts_no_launch_and_other_devices_raise():
    arrays, kw = _case("planted overlaps")
    before = merge.merge_pairs.launches
    got = merge.merge_pairs(*map(torch.from_numpy, arrays), **kw)
    _eq(got, merge.merge_pairs_torch(*map(torch.from_numpy, arrays), **kw))
    assert merge.merge_pairs.launches == before
    meta = [torch.from_numpy(a).to("meta") for a in arrays]
    with pytest.raises(ValueError, match="unsupported device"):
        merge.merge_pairs(*meta)


# ------------------------------------------------------------ on the card

@pytest.fixture
def card():
    """Skip without a CUDA device or without nvcc: the kernel has no CPU
    mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the merge kernel has no CPU mode")
    from blazeseq_tpu_torch import _kernels

    try:
        _kernels.find_nvcc()
    except RuntimeError as e:
        pytest.skip("needs nvcc to build the kernels: %s" % e)
    _kernels.load()


@pytest.mark.parametrize("label", CHIP_SMOKE.MERGE_EDGE_CASES
                         + CHIP_SMOKE.MERGE_CARD_CASES)
def test_merge_kernel_on_card(card, label):
    arrays, kw = _case(label)
    d = [torch.from_numpy(a).cuda() for a in arrays]
    before = merge.merge_pairs.launches
    got = merge.merge_pairs(*d, **kw)
    torch.cuda.synchronize()
    assert merge.merge_pairs.launches == before + (arrays[0].shape[0] > 0)
    _eq(got, merge.merge_pairs_torch(*d, **kw))


def test_merge_kernel_refuses_bad_batches_on_card(card):
    arrays, _ = _case("planted overlaps")
    d = [torch.from_numpy(a).cuda() for a in arrays]
    with pytest.raises(ValueError, match="not on a CUDA device"):
        merge.merge_pairs(d[0], d[1], d[2], d[3].cpu(), d[4], d[5])
    with pytest.raises(ValueError, match="must be contiguous"):
        merge.merge_pairs(d[0].t().contiguous().t(), *d[1:])
    with pytest.raises(ValueError, match=r"\[n, L\]"):
        merge.merge_pairs(d[0][:, :10].contiguous(), *d[1:])
    with pytest.raises(ValueError, match="int32"):
        merge.merge_pairs(*d, mismatch_penalty=1 << 40)

