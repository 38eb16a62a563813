"""The PyTorch port's overlapped chunk feed (blazeseq_tpu_torch/parallel/
ingest.py): the protocol cases of tests/test_ingest.py on the CPU path
(dispatch-order delivery, buffer recycling, early-sync stashing), the
constructor's checks, and the CUDA path (pinned staging, copy stream,
events) on the card, which skips where there is no CUDA device.

The staging copy (`stage_copy`), called on numpy arrays with the thread
count set, so that it holds on a host of any core count: byte-equal to
np.copyto around its split threshold, from a read-only mapping at an
unaligned offset; one thread below twice its floor; a worker's error
reaches the caller once every slice has finished; callers on many threads
at once.
"""

import mmap
import sys
import threading
import time

import numpy as np
import pytest
import torch

from blazeseq_tpu_torch.parallel import ingest
from blazeseq_tpu_torch.parallel.ingest import OverlappedIngest

FLOOR = ingest.STAGE_SLICE_FLOOR


def _sum_step(c, nv):
    return c.to(torch.int64).sum() + nv


def test_deferred_order_and_drain():
    csize = 64
    ing = OverlappedIngest(_sum_step, csize, depth=2, device="cpu")
    got = []
    for k in range(7):
        arr = np.full(csize, k, np.uint8)
        ready = ing.feed(arr, k + 1, meta=k, owned=False)
        # a chunk's result is withheld until it is `depth` dispatches old
        assert len(ready) == (1 if k >= 2 else 0)
        got += ready
    got += ing.drain()
    assert [m for m, _ in got] == list(range(7))
    for k, (_m, out) in enumerate(got):
        assert int(out) == csize * k + k + 1


def test_acquire_recycles_and_early_sync():
    # fewer buffers than depth+1: acquire() must sync the oldest in-flight
    # chunk to free its buffer, and its result must still arrive, in order,
    # through the next feed()/drain()
    csize = 32
    ing = OverlappedIngest(lambda c, nv: int(c[0]) * 0 + nv, csize, depth=3,
                           n_buffers=2, device="cpu")
    got = []
    for k in range(8):
        b = ing.acquire()
        b[:] = k
        got += ing.feed(b, k, meta=k)
    got += ing.drain()
    assert [m for m, _ in got] == list(range(8))
    assert [int(o) for _m, o in got] == list(range(8))


def test_acquire_without_recyclable_buffer_raises():
    ing = OverlappedIngest(lambda c, nv: None, 8, depth=2, n_buffers=1,
                           device="cpu")
    ing.acquire()  # the only buffer, never fed back
    with pytest.raises(RuntimeError):
        ing.acquire()


def test_owned_false_never_recycled_into_free_pool():
    ing = OverlappedIngest(_sum_step, 16, depth=1, n_buffers=1,
                           device="cpu")
    ro = np.arange(16, dtype=np.uint8)
    ro.flags.writeable = False  # as an mmap slice is
    ing.feed(ro, 1, owned=False)
    ing.drain()
    mine = ing.acquire()  # must be the staging buffer, not the caller's
    assert mine is not ro
    mine[:] = 0
    assert ro.sum() > 0


def test_row_bytes_shapes_the_chunk():
    seen = []
    ing = OverlappedIngest(lambda c, nv: seen.append(tuple(c.shape)), 60,
                           row_bytes=12, device="cpu")
    ing.feed(np.zeros(60, np.uint8), 60, owned=False)
    ing.drain()
    assert seen == [(5, 12)]


@pytest.mark.parametrize("kw,match", [
    (dict(row_bytes=7), "multiple of row_bytes"),
    (dict(keep_bytes=True, depth=2, n_buffers=2), "keep_bytes"),
])
def test_constructor_checks(kw, match):
    with pytest.raises(ValueError, match=match):
        OverlappedIngest(_sum_step, 64, device="cpu", **kw)


def test_cuda_device_refused_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        OverlappedIngest(_sum_step, 64)  # device defaults to cuda


@pytest.mark.parametrize("n_buffers", [None, 2])
def test_cuda_feed_matches_host_sums_on_card(n_buffers):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: pinned staging and copy streams")
    csize = 1 << 20
    rng = np.random.default_rng(5)
    chunks = [rng.integers(0, 256, csize, dtype=np.uint8) for _ in range(9)]
    ing = OverlappedIngest(lambda c, nv: c[:nv].to(torch.int64).sum(), csize,
                           row_bytes=1024, n_buffers=n_buffers)
    got = []
    for k, ch in enumerate(chunks):
        if k % 2:
            ch = ch.copy()
            ch.flags.writeable = False
            got += ing.feed(ch, csize // 1024 - k, meta=k, owned=False)
        else:
            b = ing.acquire()
            b[:] = ch
            got += ing.feed(b, csize // 1024 - k, meta=k)
    got += ing.drain()
    assert [m for m, _ in got] == list(range(9))
    for k, out in got:
        rows = csize // 1024 - k
        assert int(out) == int(chunks[k][: rows * 1024].astype(np.int64).sum())


# around the split threshold (twice the floor), and sizes that 3 threads
# do not divide
STAGE_SIZES = [0, 1, 2 * FLOOR - 1, 2 * FLOOR, 2 * FLOOR + 1,
               3 * FLOOR + 7, 5 * FLOOR + 1]


@pytest.fixture(scope="module")
def mapped(tmp_path_factory):
    """A read-only mapping of random bytes, 13 bytes longer than the
    largest size."""
    p = tmp_path_factory.mktemp("stage") / "bytes.bin"
    np.random.default_rng(3).integers(
        0, 256, max(STAGE_SIZES) + 13, dtype=np.uint8).tofile(p)
    with open(p, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, prot=mmap.PROT_READ)
    yield np.frombuffer(mm, np.uint8)


@pytest.mark.parametrize("threads", [1, 3])
@pytest.mark.parametrize("at", [0, 13])
@pytest.mark.parametrize("n", STAGE_SIZES)
def test_stage_copy_equals_copyto(mapped, monkeypatch, n, at, threads):
    monkeypatch.setattr(ingest, "_stage_threads", lambda: threads)
    src = mapped[at:at + n]
    assert not src.flags.writeable
    dst = np.zeros(n, np.uint8)
    want = np.empty(n, np.uint8)
    np.copyto(want, src)
    used = ingest.stage_copy(dst, src)
    assert np.array_equal(dst, want)
    assert used == max(1, min(threads, n // FLOOR))


def test_stage_copy_below_twice_the_floor_takes_one_thread(monkeypatch):
    def no_pool():
        raise AssertionError("a small copy reached the pool")

    monkeypatch.setattr(ingest, "_stage_threads", lambda: 8)
    monkeypatch.setattr(ingest, "_stage_pool", no_pool)
    src = np.arange(2 * FLOOR - 1, dtype=np.uint64).astype(np.uint8)
    dst = np.zeros_like(src)
    assert ingest.stage_copy(dst, src) == 1
    assert np.array_equal(dst, src)


def test_stage_copy_raises_a_workers_error_after_every_slice(monkeypatch):
    # slices start at 0, s, 2s, 3s: the last raises at once, the second
    # sleeps first; the error may reach the caller only after the slow one
    # has finished its copy
    monkeypatch.setattr(ingest, "_stage_threads", lambda: 4)
    n = 4 * FLOOR
    copy = ingest._copy_slice

    def slice_(dst, src, a, b):
        if a == 3 * FLOOR:
            raise OSError("slice at %d" % a)
        if a == FLOOR:
            time.sleep(0.3)
        copy(dst, src, a, b)

    monkeypatch.setattr(ingest, "_copy_slice", slice_)
    src = np.random.default_rng(4).integers(0, 256, n, dtype=np.uint8)
    dst = np.zeros(n, np.uint8)
    with pytest.raises(OSError, match="slice at %d" % (3 * FLOOR)):
        ingest.stage_copy(dst, src)
    assert np.array_equal(dst[:3 * FLOOR], src[:3 * FLOOR])
    assert not dst[3 * FLOOR:].any()


def test_stage_copy_from_many_threads_at_once(monkeypatch):
    # more callers than cores share the one pool; each copy must come out
    # whole
    monkeypatch.setattr(ingest, "_stage_threads", lambda: 4)
    monkeypatch.setattr(ingest, "STAGE_SLICE_FLOOR", 4096)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    bad = []

    def caller(k):
        rng = np.random.default_rng(k)
        for _ in range(20):
            n = int(rng.integers(0, 64 << 10))
            src = rng.integers(0, 256, n, dtype=np.uint8)
            dst = np.zeros(n, np.uint8)
            try:
                ingest.stage_copy(dst, src)
            except Exception as e:  # noqa: BLE001 - reported below
                bad.append((k, repr(e)))
            if not np.array_equal(dst, src):
                bad.append(k)

    try:
        ths = [threading.Thread(target=caller, args=(k,)) for k in range(16)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(60)
        assert not any(th.is_alive() for th in ths)
    finally:
        sys.setswitchinterval(interval)
    assert bad == []
