"""Parity: the PyTorch port's alignment ops (blazeseq_tpu_torch/ops/nw.py)
against blazeseq_tpu/ops/nw.py.

`nw_scores_torch` is held against the Pallas kernel nw_scores_pallas
(interpret mode on the CPU, as the reference's own tests run it, at small
shapes) and against nw_scores_xla at larger ones; the five XLA-only
variants against their JAX versions; each numpy twin against the
reference's. Scores are integers, so every comparison is exact
(np.array_equal). The CUDA kernel is held against the plain version on the
card, and those cases skip where there is no CUDA device.
"""

import numpy as np
import pytest
import torch

from blazeseq_tpu_torch import _kernels
from blazeseq_tpu_torch.ops import nw

ACGT = np.frombuffer(b"ACGT", np.uint8)
# ACGT plus the reference kernel's two sentinel bytes
SENTINELS = np.frombuffer(b"ACGT\xfe\xff", np.uint8)


def _ref():
    """jax.numpy and the reference nw module, imported per test, so that
    the card cases also run where only the port is installed."""
    ref = pytest.importorskip("blazeseq_tpu.ops.nw")
    import jax.numpy as jnp

    return jnp, ref


def _inputs(B, Lq, Lr, seed, alphabet=ACGT):
    """seq u8[B, Lq], lengths i32[B] with 0 and Lq among them, ref u8[Lr]."""
    rng = np.random.default_rng(seed)
    seq = rng.choice(alphabet, (B, Lq))
    ref = rng.choice(alphabet, Lr)
    lengths = rng.integers(0, Lq + 1, B).astype(np.int32)
    lengths[0] = 0
    lengths[1] = Lq
    return seq, lengths, ref


def _port(fn, seq, lengths, ref, **kw):
    return fn(torch.from_numpy(seq), torch.from_numpy(lengths),
              torch.from_numpy(ref), **kw).numpy()


# Pallas interpret mode is slow: B <= 32, Lq <= 64, Lr <= 48
PALLAS_CASES = {
    "acgt": (16, 40, 30, ACGT),
    "sentinels": (16, 32, 24, SENTINELS),
    "ref_len_1": (8, 16, 1, SENTINELS),
    "wide": (8, 64, 48, ACGT),
}


@pytest.mark.parametrize("case", sorted(PALLAS_CASES))
def test_plain_matches_pallas_kernel(case):
    jnp, ref_mod = _ref()
    B, Lq, Lr, alphabet = PALLAS_CASES[case]
    seq, lengths, ref = _inputs(B, Lq, Lr, seed=Lq + Lr, alphabet=alphabet)
    if case == "sentinels":
        ref[0] = 0xFF  # a reference that starts with the out-of-range byte
    want = np.asarray(ref_mod.nw_scores_pallas(
        jnp.asarray(seq), jnp.asarray(lengths), jnp.asarray(ref)))
    got = _port(nw.nw_scores_torch, seq, lengths, ref)
    np.testing.assert_array_equal(want, got)
    assert got.dtype == np.int32
    assert got[0] == -Lr  # a read of length 0 is the pure-gap alignment


XLA_CASES = {
    "acgt": (64, 128, 100, ACGT),
    "sentinels": (40, 200, 37, SENTINELS),
    "ref_len_1": (33, 64, 1, ACGT),
    "long_ref": (24, 48, 300, ACGT),
}


@pytest.mark.parametrize("case", sorted(XLA_CASES))
def test_plain_matches_xla(case):
    jnp, ref_mod = _ref()
    B, Lq, Lr, alphabet = XLA_CASES[case]
    seq, lengths, ref = _inputs(B, Lq, Lr, seed=B + Lq, alphabet=alphabet)
    want = np.asarray(ref_mod.nw_scores_xla(
        jnp.asarray(seq), jnp.asarray(lengths), jnp.asarray(ref)))
    got = _port(nw.nw_scores_torch, seq, lengths, ref)
    np.testing.assert_array_equal(want, got)
    for b in range(6):
        assert got[b] == nw.needleman_wunsch_cpu(
            seq[b, :lengths[b]].tobytes(), ref.tobytes())


VARIANTS = [
    ("sw_scores", "sw_scores_xla", {}),
    ("sw_scores", "sw_scores_xla", dict(gap=-2)),
    ("nw_semiglobal_scores", "nw_semiglobal_scores_xla", {}),
    ("nw_semiglobal_scores", "nw_semiglobal_scores_xla", dict(gap=-2)),
    ("nw_affine_scores", "nw_affine_scores_xla", dict(gap_open=-3)),
    ("nw_affine_scores", "nw_affine_scores_xla", dict(gap_open=-5)),
    ("sw_affine_scores", "sw_affine_scores_xla", dict(gap_open=-3)),
    ("sw_affine_scores", "sw_affine_scores_xla", dict(gap_open=-5)),
    ("nw_semiglobal_affine_scores", "nw_semiglobal_affine_scores_xla",
     dict(gap_open=-3)),
    ("nw_semiglobal_affine_scores", "nw_semiglobal_affine_scores_xla",
     dict(gap_open=-5, gap_extend=-2)),
]


@pytest.mark.parametrize("port_name,ref_name,kw", VARIANTS,
                         ids=["%s%s" % (p, "".join("_%s%d" % i for i in
                                                   sorted(k.items())))
                              for p, _, k in VARIANTS])
def test_variant_matches_xla(port_name, ref_name, kw):
    jnp, ref_mod = _ref()
    seq, lengths, ref = _inputs(48, 64, 45, seed=len(port_name),
                                alphabet=SENTINELS)
    want = np.asarray(getattr(ref_mod, ref_name)(
        jnp.asarray(seq), jnp.asarray(lengths), jnp.asarray(ref), **kw))
    got = _port(getattr(nw, port_name), seq, lengths, ref, **kw)
    np.testing.assert_array_equal(want, got)
    assert got.dtype == np.int32


TWINS = [
    ("needleman_wunsch_cpu", {}), ("needleman_wunsch_cpu", dict(gap=-2)),
    ("smith_waterman_cpu", {}), ("semiglobal_cpu", {}),
    ("needleman_wunsch_affine_cpu", dict(gap_open=-5)),
    ("smith_waterman_affine_cpu", dict(gap_open=-3)),
    ("semiglobal_affine_cpu", dict(gap_open=-4, gap_extend=-2)),
]


@pytest.mark.parametrize("name,kw", TWINS,
                         ids=["%s-%d" % (n, i) for i, (n, _) in
                              enumerate(TWINS)])
def test_twin_matches_reference_twin(name, kw):
    _, ref_mod = _ref()
    rng = np.random.default_rng(len(name))
    for _ in range(12):
        q = rng.choice(ACGT, int(rng.integers(0, 30))).tobytes()
        r = rng.choice(ACGT, int(rng.integers(1, 25))).tobytes()
        assert getattr(nw, name)(q, r, **kw) == \
            getattr(ref_mod, name)(q, r, **kw), (q, r)


def test_empty_reference_is_refused():
    jnp, ref_mod = _ref()
    seq, lengths, _ = _inputs(4, 16, 1, seed=1)
    empty = np.zeros(0, np.uint8)
    with pytest.raises(TypeError):
        ref_mod.nw_scores_xla(jnp.asarray(seq), jnp.asarray(lengths),
                              jnp.asarray(empty))
    for fn in (nw.nw_scores, nw.nw_scores_torch, nw.sw_scores,
               nw.nw_affine_scores):
        with pytest.raises(ValueError, match="non-empty"):
            _port(fn, seq, lengths, empty)


def test_dispatch_cpu_takes_the_plain_version():
    seq, lengths, ref = _inputs(32, 64, 20, seed=5)
    before = nw.nw_scores.launches
    got = _port(nw.nw_scores, seq, lengths, ref)
    np.testing.assert_array_equal(
        got, _port(nw.nw_scores_torch, seq, lengths, ref))
    assert nw.nw_scores.launches == before  # no kernel on the CPU


def test_dispatch_refuses_other_devices():
    seq = torch.zeros((4, 16), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        nw.nw_scores(seq, torch.zeros(4, dtype=torch.int32, device="meta"),
                     torch.zeros(3, dtype=torch.uint8, device="meta"))


class _LooksCuda(torch.Tensor):
    """A CPU tensor that reports is_cuda, to reach the CUDA dispatch branch
    without a card."""

    @property
    def is_cuda(self):
        return True


def test_cuda_dispatch_raises_when_kernels_cannot_load(monkeypatch):
    def fail():
        raise RuntimeError("kernel library unavailable (test)")

    def plain_must_not_run(*a, **k):
        raise AssertionError("plain version reached from the CUDA branch")

    monkeypatch.setattr(_kernels, "load", fail)
    monkeypatch.setattr(nw, "nw_scores_torch", plain_must_not_run)
    seq, lengths, ref = (torch.Tensor._make_subclass(
        _LooksCuda, torch.from_numpy(a)) for a in _inputs(4, 16, 8, seed=2))
    before = nw.nw_scores.launches
    with pytest.raises(RuntimeError, match="kernel library unavailable"):
        nw.nw_scores(seq, lengths, ref)
    assert nw.nw_scores.launches == before


CARD_CASES = {
    "example_shape": (65536, 64, 40, ACGT),
    "qc_batch": (4096, 256, 150, ACGT),
    "edges_ref_1": (600, 64, 1, SENTINELS),
    "edges_ref_1000": (600, 64, 1000, SENTINELS),
    "width_512": (300, 512, 77, ACGT),
}


@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_kernel_matches_plain_on_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    B, Lq, Lr, alphabet = CARD_CASES[case]
    seq, lengths, ref = _inputs(B, Lq, Lr, seed=Lr, alphabet=alphabet)
    # lengths the callers never pass, held against the plain version too
    lengths[2:4] = Lq + 3
    lengths[4:6] = -1
    lengths[6] = -Lr - 5
    d = [torch.from_numpy(a).cuda() for a in (seq, lengths, ref)]
    before = nw.nw_scores.launches
    got = nw.nw_scores(*d)
    want = nw.nw_scores_torch(*d)
    torch.cuda.synchronize()
    assert nw.nw_scores.launches == before + 1
    assert torch.equal(got, want)
    host = got.cpu().numpy()
    for b in (0, 1, 7, 8, 9):
        assert host[b] == nw.needleman_wunsch_cpu(
            seq[b, :lengths[b]].tobytes(), ref.tobytes())
