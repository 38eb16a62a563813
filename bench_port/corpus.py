"""The files a run makes: the corpus, a temporary file under TMPDIR
(deleted when the run ends), and the CLI's output, an anonymous in-memory
file (memfd) passed to the port by its /proc/self/fd path and emptied
before each request.

Why the corpus is not in memory too: on the chip machine (a gVisor
sandbox) a fresh map of a memfd reads at 0.5-0.85 GB/s against 5.8-8.7
GB/s for a file on its root filesystem (PERF.md), and the port maps its
input anew every request, so a memfd corpus would time the sandbox's page
faults and not the port. The output stays in memory: it is written a
whole file a request, which on disk would be tens of GiB a run.
"""

from __future__ import annotations

import mmap
import os
import tempfile
from dataclasses import dataclass, field

import numpy as np


class File:
    """A file of this run: on disk under TMPDIR (`in_memory=False`, with a
    random name, deleted by close()) or an anonymous memory file."""

    def __init__(self, name: str, in_memory: bool):
        if in_memory:
            self.fd = os.memfd_create(name, os.MFD_CLOEXEC)
            self.path = "/proc/self/fd/%d" % self.fd
            self._unlink = None
        else:
            self.fd, self.path = tempfile.mkstemp(
                prefix="bench_port_%s_" % name, suffix=".fastq")
            self._unlink = self.path
        self._mm = None

    def write_at(self, at: int, data: np.ndarray) -> None:
        view, done = memoryview(np.ascontiguousarray(data)).cast("B"), 0
        while done < len(view):
            done += os.pwrite(self.fd, view[done:], at + done)

    def size(self) -> int:
        return os.fstat(self.fd).st_size

    def array(self) -> np.ndarray:
        """The whole file as a read-only uint8 array (valid until clear,
        release or close)."""
        self.release()
        n = self.size()
        if n == 0:
            return np.empty(0, np.uint8)
        self._mm = mmap.mmap(self.fd, n, prot=mmap.PROT_READ)
        return np.frombuffer(self._mm, np.uint8)

    def read(self) -> np.ndarray:
        """A copy of the file's bytes."""
        n = self.size()
        out = np.empty(n, np.uint8)
        view, at = memoryview(out), 0
        while at < n:
            k = os.preadv(self.fd, [view[at:]], at)
            if k <= 0:
                raise OSError("short read of %s" % self.path)
            at += k
        return out

    def clear(self) -> None:
        self.release()
        os.ftruncate(self.fd, 0)

    def release(self) -> None:
        """Drop the map that `array()` made."""
        if self._mm is not None:
            try:
                self._mm.close()
            except BufferError:
                pass  # a view is still alive; the map goes with it
            self._mm = None

    def close(self) -> None:
        self.release()
        os.close(self.fd)
        if self._unlink:
            os.unlink(self._unlink)
            self._unlink = None


@dataclass
class Corpus:
    """A generated FASTQ file and what its generator planted."""

    file: File
    reads: int
    nbytes: int
    planted: dict = field(default_factory=dict)

    @property
    def path(self) -> str:
        return self.file.path
