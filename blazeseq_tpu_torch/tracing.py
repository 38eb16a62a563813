"""Tracing (counterpart of blazeseq_tpu/tracing.py).

`Tracer` holds named host wall-clock sections (they nest) and counters,
with a report() summary; `global_tracer()` is the process-wide one.
`device_trace(dir)` captures a torch.profiler trace of the enclosed block
(CPU activity, and CUDA kernels and copies when a card is present) and
writes it into `dir` as a Chrome trace, `trace.json`, which chrome://tracing
or Perfetto opens.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import torch

__all__ = ["Tracer", "device_trace", "global_tracer"]


class Tracer:
    def __init__(self):
        self.times: Dict[str, float] = defaultdict(float)
        self.calls: Dict[str, int] = defaultdict(int)
        self.counters: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            self.times[name] += time.perf_counter() - t0
            self.calls[name] += 1

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] += n

    def rate(self, name: str, bytes_processed: int) -> float:
        t = self.times.get(name, 0.0)
        return bytes_processed / t / 1e9 if t else 0.0

    def report(self) -> str:
        lines = ["== trace report =="]
        total = sum(self.times.values())
        for name, t in sorted(self.times.items(), key=lambda kv: -kv[1]):
            lines.append("%-28s %8.3fs %5.1f%% (%d calls)"
                         % (name, t, 100 * t / total if total else 0,
                            self.calls[name]))
        for name, v in sorted(self.counters.items()):
            lines.append("%-28s %d" % (name, v))
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(trace_dir: str):
    """Profile the enclosed block; yields `trace_dir`. The trace lands in
    `trace_dir/trace.json` when the block ends, also when it raises."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield trace_dir
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


_GLOBAL = Tracer()


def global_tracer() -> Tracer:
    return _GLOBAL
