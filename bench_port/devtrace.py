"""The traced stretch: torch.profiler (CPU and CUDA activity) over the
window's first requests, and what its trace says.

The trace is exported as a Chrome trace into a temporary directory under
TMPDIR, read back and deleted. Device activity is every kernel, copy and
fill on the card; an idle gap is named by the innermost host range (a
Python function, an aten op, a CUDA runtime call, or the harness's
`bench.*` and `entry.*` ranges) open on the request's thread at the gap's
middle.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "user_annotation", "cuda_driver",
             "python_function")
STRETCH = "bench.stretch"
_ADDRESS = re.compile(r" at 0x[0-9a-f]+")  # in the names of bound methods
TOP = 10


@dataclass
class Summary:
    """The traced stretch: its length, the device's busy time, each device
    operation's time by name, the HtoD copies, and the idle gaps' time by
    what the host was doing."""

    window_s: float
    busy_s: float
    ops: dict = field(default_factory=dict)  # name -> (seconds, count)
    h2d_bytes: int = 0
    h2d_s: float = 0.0
    gaps: dict = field(default_factory=dict)  # host name -> seconds

    def kernel_seconds(self, *needles) -> float:
        """Summed time of the device kernels whose name holds a needle."""
        return sum(s for name, (s, _) in self.ops.items()
                   if any(n in name for n in needles))

    def breakdown(self) -> dict:
        ops = sorted(self.ops.items(), key=lambda kv: -kv[1][0])[:TOP]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:TOP]
        return dict(device_ops=[[k, s] for k, (s, _) in ops],
                    idle_gaps=[[k, s] for k, s in gaps])


class Stretch:
    """start() and stop() around the traced requests; summary() after."""

    def __init__(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        # with_stack: Python calls become events, so that an idle gap is
        # named by the port's function the host was in
        self._prof = torch.profiler.profile(activities=acts, with_stack=True)
        self._range = None

    def start(self) -> None:
        self._prof.start()
        self._range = torch.profiler.record_function(STRETCH)
        self._range.__enter__()

    def stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._range.__exit__(None, None, None)
        self._prof.stop()

    def summary(self) -> Summary:
        tmp = tempfile.mkdtemp(prefix="bench_port_trace_")
        try:
            path = os.path.join(tmp, "trace.json")
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        if isinstance(events, dict):
            events = events.get("traceEvents", [])
        return summarize(events)


def _union(intervals):
    """Merged [start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events) -> Summary:
    """A Summary from Chrome-trace events (times in microseconds)."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    marks = [e for e in xs if e.get("name") == STRETCH
             and e.get("cat") == "user_annotation"]
    if not marks:
        return Summary(window_s=0.0, busy_s=0.0)
    mark = marks[0]
    t0, t1 = float(mark["ts"]), float(mark["ts"]) + float(mark["dur"])
    ops = defaultdict(lambda: [0.0, 0])
    busy = []
    h2d_bytes, h2d_us = 0, 0.0
    for e in xs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        s, d = float(e["ts"]), float(e["dur"])
        if s + d <= t0 or s >= t1:
            continue
        s, end = max(s, t0), min(s + d, t1)
        busy.append((s, end))
        o = ops[e["name"]]
        o[0] += (end - s) * 1e-6
        o[1] += 1
        if e.get("cat") == "gpu_memcpy" and "HtoD" in e["name"]:
            h2d_bytes += int(e.get("args", {}).get("bytes", 0))
            h2d_us += d
    merged = _union(busy)
    busy_us = sum(e - s for s, e in merged)
    gaps = defaultdict(float)
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    _ADDRESS.sub("", e["name"])) for e in xs
                   if e.get("cat") in HOST_CATS
                   and e.get("tid") == mark.get("tid")
                   and e.get("pid") == mark.get("pid")
                   and e["name"] != STRETCH),
                  key=lambda h: (h[0], -h[1]))
    edges = [t0] + [v for iv in merged for v in iv] + [t1]
    idle = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    names = _innermost(host, [0.5 * (a + b) for a, b in idle])
    for (a, b), name in zip(idle, names):
        gaps[name] += (b - a) * 1e-6
    return Summary(window_s=(t1 - t0) * 1e-6, busy_s=busy_us * 1e-6,
                   ops={k: (v[0], v[1]) for k, v in ops.items()},
                   h2d_bytes=h2d_bytes, h2d_s=h2d_us * 1e-6,
                   gaps=dict(gaps))


def _innermost(host, points):
    """For each point (ascending), the name of the innermost host range
    (start, end, name), sorted by start and nested, that holds it."""
    out, stack, j = [], [], 0
    for m in points:
        while j < len(host) and host[j][0] <= m:
            while stack and stack[-1][1] < host[j][0]:
                stack.pop()
            stack.append(host[j])
            j += 1
        while stack and stack[-1][1] < m:
            stack.pop()
        out.append(stack[-1][2] if stack else "host")
    return out
