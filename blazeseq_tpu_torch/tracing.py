"""Tracing (counterpart of blazeseq_tpu/tracing.py).

`Tracer` and `global_tracer` are the reference's host wall-clock sections
and counters, re-exported unchanged. `device_trace(dir)` captures a
torch.profiler trace of the enclosed block (CPU activity, and CUDA kernels
and copies when a card is present) and writes it into `dir` as a Chrome
trace, `trace.json`, which chrome://tracing or Perfetto opens.
"""

from __future__ import annotations

import contextlib
import os

import torch

from blazeseq_tpu.tracing import Tracer, global_tracer

__all__ = ["Tracer", "device_trace", "global_tracer"]


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
