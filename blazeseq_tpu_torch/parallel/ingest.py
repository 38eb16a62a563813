"""Overlapped host-to-device chunk feed (counterpart of
blazeseq_tpu/parallel/ingest.py).

The feed (memcpy from the file mapping), the host-to-device copy and the
device step should overlap, so that steady-state throughput is the slowest
stage's rate and not the sum of all three. On CUDA:

  host memcpy chunk k+1 | copy stream: H2D chunk k | compute: step chunk k-1
  (into pinned staging) | (async, pinned source)   | (PyTorch's stream)

Each chunk is copied from the caller's host array into a pinned staging
buffer, then uploaded on a separate copy stream into one of a ring of
device buffers; the compute stream waits on the upload's event, runs the
step, and records a done event. A staging buffer is reused only after its
upload event completed, and a device buffer only after the step that read
it (the copy stream waits on that step's event). A pageable array (such as
a read-only mmap slice) could not be uploaded asynchronously, which is why
the staging copy exists.

On CPU every step runs synchronously on a tensor that views the caller's
array.

The protocol and the buffer-recycling contract are the reference's: a
result is delivered `depth` dispatches after its chunk, a buffer from
`acquire()` is recycled only once its chunk's result has been synced, and
`keep_bytes=True` guarantees delivery through feed() before the buffer
re-enters rotation.
"""

from __future__ import annotations

import warnings
from collections import deque
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from .. import native


class OverlappedIngest:
    """Deferred-sync dispatch queue for chunked device steps.

    step(chunk u8[csize] or u8[csize // row_bytes, row_bytes] on `device`,
    n_valid: int) -> result. The result is returned to the caller only
    `depth` dispatches later (or at drain).

    Protocol per chunk::

        buf = ing.acquire()            # rotating host buffer (may sync one)
        n = fill(buf)                  # memcpy / readinto, pad tail
        for meta, out in ing.feed(buf, n, meta=pos):
            consume(out)               # ready results, dispatch order
        ...
        for meta, out in ing.drain():  # flush the queue at EOF
            consume(out)

    Read-only arrays the caller owns for the whole run (an mmap'd file's
    full-size slices) are fed directly with `feed(arr, n, owned=False)`.
    """

    def __init__(self, step: Callable, csize: int, *, depth: int = 2,
                 n_buffers: Optional[int] = None,
                 keep_bytes: bool = False, row_bytes: Optional[int] = None,
                 device="cuda"):
        self.step = step
        self.csize = int(csize)
        # with row_bytes=rs each chunk reaches the step as [csize//rs, rs]
        self.row_bytes = int(row_bytes) if row_bytes else None
        if self.row_bytes and self.csize % self.row_bytes:
            raise ValueError("csize must be a multiple of row_bytes")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("OverlappedIngest(device=%r): CUDA is not "
                               "available" % str(device))
        self.depth = max(0, int(depth))
        nb = n_buffers if n_buffers is not None else self.depth + 1
        # Recycling contract: when acquire() has to early-sync the oldest
        # in-flight chunk (every buffer busy, i.e. n_buffers <= depth), that
        # chunk's BUFFER is recycled immediately while its RESULT is only
        # delivered by the next feed()/drain(). Consumers that read a
        # delivered chunk's buffer contents must pass keep_bytes=True, which
        # pins n_buffers above depth so a chunk is always synced through
        # feed() BEFORE its buffer re-enters rotation.
        if keep_bytes and nb <= self.depth:
            raise ValueError(
                "OverlappedIngest(keep_bytes=True): n_buffers (%d) must "
                "exceed depth (%d); a delivered result's buffer would "
                "otherwise be recycled before the caller could read it"
                % (nb, self.depth))
        # buffers materialize on first acquire(): the zero-copy mmap path
        # needs at most one (for the trailing partial chunk)
        self._unallocated = max(1, nb)
        self._free: List[np.ndarray] = []
        # (meta, out, buf-or-None, done event-or-None) in dispatch order
        self._inflight: deque = deque()
        # results acquire() had to sync early; handed out by next feed/drain
        self._early: List[Tuple[Any, Any]] = []
        if self.device.type == "cuda":
            self._copy_stream = torch.cuda.Stream(self.device)
            # device ring: one slot per chunk that can be in flight, plus the
            # one being uploaded; each remembers the step that last read it
            self._dev = [torch.empty(self.csize, dtype=torch.uint8,
                                     device=self.device)
                         for _ in range(self.depth + 1)]
            self._dev_done: List[Optional[torch.cuda.Event]] = \
                [None] * len(self._dev)
            self._slot = 0
            # two pinned staging buffers: fill one while the other uploads
            self._pinned = [torch.empty(self.csize, dtype=torch.uint8,
                                        pin_memory=True) for _ in range(2)]
            self._pinned_done: List[Optional[torch.cuda.Event]] = [None, None]
            self._stage = 0

    # -- producer side --------------------------------------------------------
    def acquire(self) -> np.ndarray:
        """A host buffer safe to overwrite. Syncs the oldest in-flight chunk
        first if every buffer is busy; its result is delivered (in order) by
        the next feed()/drain() call."""
        while not self._free:
            if self._unallocated:
                self._unallocated -= 1
                return native.aligned_empty(self.csize)
            if not self._inflight:
                raise RuntimeError("no free buffer and nothing in flight "
                                   "(a fed owned buffer was never returned)")
            self._early.append(self._sync_oldest())
        return self._free.pop()

    def feed(self, buf: np.ndarray, n_valid: int, meta: Any = None,
             owned: bool = True) -> List[Tuple[Any, Any]]:
        """Dispatch one chunk and return any results that became ready,
        oldest first. `owned=True` marks `buf` as an acquire()d buffer to
        recycle after sync; pass owned=False for caller-owned read-only
        arrays (never written again during the run)."""
        if self.device.type == "cuda":
            dev, done = self._upload(buf), torch.cuda.Event()
        else:
            with warnings.catch_warnings():
                # read-only mmap slices: the step only reads the tensor
                warnings.simplefilter("ignore", UserWarning)
                dev, done = torch.from_numpy(np.ascontiguousarray(buf)), None
        if self.row_bytes:
            dev = dev.view(-1, self.row_bytes)
        out = self.step(dev, int(n_valid))
        if done is not None:
            done.record(torch.cuda.current_stream(self.device))
            self._dev_done[self._slot] = done
            self._slot = (self._slot + 1) % len(self._dev)
        self._inflight.append((meta, out, buf if owned else None, done))
        ready, self._early = self._early, []
        while len(self._inflight) > self.depth:
            ready.append(self._sync_oldest())
        return ready

    def drain(self) -> List[Tuple[Any, Any]]:
        """Sync and return every remaining in-flight result, oldest first."""
        ready, self._early = self._early, []
        while self._inflight:
            ready.append(self._sync_oldest())
        return ready

    # -- internals ----------------------------------------------------------
    def _upload(self, buf: np.ndarray) -> torch.Tensor:
        """Stage `buf` into pinned memory, upload it on the copy stream into
        the current device slot, and make the compute stream wait for it."""
        n = buf.size
        if n > self.csize:
            raise ValueError("chunk of %d bytes exceeds csize %d"
                             % (n, self.csize))
        k = self._stage
        self._stage ^= 1
        if self._pinned_done[k] is not None:
            self._pinned_done[k].synchronize()  # its last upload finished
        pinned = self._pinned[k][:n]
        np.copyto(pinned.numpy(), buf.reshape(-1))
        dev = self._dev[self._slot][:n]
        copied = torch.cuda.Event()
        with torch.cuda.stream(self._copy_stream):
            if self._dev_done[self._slot] is not None:
                # the step that last read this slot must finish first
                self._copy_stream.wait_event(self._dev_done[self._slot])
            dev.copy_(pinned, non_blocking=True)
            copied.record(self._copy_stream)
        self._pinned_done[k] = copied
        torch.cuda.current_stream(self.device).wait_event(copied)
        return dev

    def _sync_oldest(self) -> Tuple[Any, Any]:
        meta, out, buf, done = self._inflight.popleft()
        if done is not None:
            done.synchronize()
        if buf is not None:
            self._free.append(buf)
        return meta, out
